"""k3_roofline_pct: K3 (rbf_bwd_reductions) at its share of the roofline
in the traced job.

The least time a call could take is the larger of its bytes over the
H100 SXM's 3.35 TB/s and its operations over 67 TFLOP/s (float32 outside
the tensor cores; 34 for float64), counted for the observed rows n (not
the padding to 128) from this frozen copy of the program's
``gram_kernels.min_traffic``: Ainv and Kt (n, n), alpha, the mask and X
(n, d) read once each; S1, rw (n), WX (n, d) and the diagonal's sum
written; (2 d + 6) operations an entry. The share is that bound times the
calls over the kernel's device time in the profiler's trace."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {4: 67e12, 8: 34e12}
KERNEL = "rbf_bwd_kernel"


def traffic(n, d, itemsize):
    """(bytes, operations) of one call."""
    read = (2 * n * n + n + n + n * d) * itemsize
    written = (2 + n + n * d) * itemsize
    return read + written, (2 * d + 6) * n * n


def read(run):
    t, job = run.trace, run.traced
    if t is None or job is None or "n_obs" not in job:
        return None
    sec = calls = 0
    for name, (s, c) in t.ops.items():
        if KERNEL in name:
            sec, calls = sec + s, calls + c
    if calls == 0 or sec <= 0:
        return None
    item = job["itemsize"]
    nbytes, ops = traffic(job["n_obs"], job["dims"], item)
    bound = max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S[item])
    return 100.0 * calls * bound / sec
