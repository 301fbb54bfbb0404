"""ski_cg_iters_per_step: the realized CG iterations of the training
solves (the engine's ``last_cg_iters``) over the Adam steps, over the jobs
outside the traced one."""


def read(run):
    jobs = [j for j in run.plain_jobs if "cg_iters" in j]
    steps = sum(j["steps"] for j in jobs)
    return sum(j["cg_iters"] for j in jobs) / steps if steps else None
