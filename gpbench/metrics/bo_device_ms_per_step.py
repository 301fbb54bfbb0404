"""bo_device_ms_per_step: the seconds in which an operation ran on the
card over the whole window (the union of the device operations'
intervals in the profiler's trace of the window), in ms, over all
exploration steps of the campaigns completed in it."""


def read(run):
    t = run.window_trace
    steps = sum(j["steps"] for j in run.jobs if "waits" in j)
    if t is None or t.busy_s <= 0 or not steps:
        return None
    return 1e3 * t.busy_s / steps
