"""launches_per_step.bo: device operations (kernels, copies, fills) in the
profiler's trace of the traced campaign, over its exploration steps
(construction and the trailing refit included)."""


def read(run):
    t = run.trace
    if t is None or t.launches == 0 or "waits" not in run.traced:
        return None
    return t.launches / run.traced["steps"]
