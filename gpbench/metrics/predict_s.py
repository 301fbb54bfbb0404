"""predict_s: seconds of the .predict() span on the whole grid, the mean
over the jobs outside the traced one."""


def read(run):
    jobs = [j for j in run.plain_jobs if "predict_s" in j]
    return sum(j["predict_s"] for j in jobs) / len(jobs) if jobs else None
