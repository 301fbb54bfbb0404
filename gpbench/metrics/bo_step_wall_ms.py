"""bo_step_wall_ms: the campaigns' time on the host's clock over their
exploration steps, in ms, for the campaigns outside the traced one;
construction and run()'s trailing refit counted."""


def read(run):
    camps = [j for j in run.plain_jobs if "waits" in j]
    steps = sum(j["steps"] for j in camps)
    return 1e3 * sum(j["clock_s"] for j in camps) / steps if steps else None
