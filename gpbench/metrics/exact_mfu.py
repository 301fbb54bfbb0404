"""exact_mfu: the whole reconstruction's share of the H100 SXM's peak in
the job's precision: 67 TFLOP/s both for float32 outside the tensor cores
(the program runs no TF32) and for float64 on them (cuBLAS's and
cuSOLVER's float64 products run there).

A job's operations: each Adam step n^3 (the Cholesky factor n^3/3, the
triangular inverse n^3/3, the product of the inverse factor n^3/3) for the
observed n, and 2 m n^2 for the prediction at m grid points. All jobs'
operations over the sum of their clocks (jobs outside the traced one)."""

PEAK_OPS_PER_S = {4: 67e12, 8: 67e12}


def operations(steps, n, m):
    return steps * float(n) ** 3 + 2.0 * m * float(n) ** 2


def read(run):
    jobs = [j for j in run.plain_jobs if "n_obs" in j]
    if not jobs:
        return None
    ops = sum(operations(j["steps"], j["n_obs"], j["n_test"]) for j in jobs)
    peak = sum(j["clock_s"] * PEAK_OPS_PER_S[j["itemsize"]] for j in jobs)
    return 100.0 * ops / peak
