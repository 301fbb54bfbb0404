"""train_ms_per_step: the .train() span over all its Adam steps, in ms a
step, over the jobs outside the traced one."""


def read(run):
    jobs = [j for j in run.plain_jobs if "train_s" in j]
    steps = sum(j["steps"] for j in jobs)
    return 1e3 * sum(j["train_s"] for j in jobs) / steps if steps else None
