"""ski_precond_ms_per_build: the mean ``ski.precond`` span (one training
preconditioner build: the factors' eigenpairs, the top modes, the Nystrom
core over the observed cells and its eigenpairs), in ms, over the jobs
outside the traced one."""


def read(run):
    parts = [j["spans"]["ski.precond"] for j in run.plain_jobs
             if "ski.precond" in j.get("spans", {})]
    n = sum(c for _, c in parts)
    return 1e3 * sum(s for s, _ in parts) / n if n else None
