"""device_idle_pct.bo: the share of the traced campaign's window in which
no operation ran on the card, from the profiler's device events."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or "waits" not in run.traced:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
