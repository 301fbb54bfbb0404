"""prep_s: seconds a job spends in the front door, the grid preparation
(utils.get_sparse_grid, get_full_grid) and the model's constructor; the
mean over the jobs outside the traced one."""


def read(run):
    jobs = [j for j in run.plain_jobs if "prep_s" in j]
    return sum(j["prep_s"] for j in jobs) / len(jobs) if jobs else None
