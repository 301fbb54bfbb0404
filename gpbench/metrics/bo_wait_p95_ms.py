"""bo_wait_p95_ms: the 95th percentile, in ms, of the instrument's wait
over every step of the campaigns outside the traced one: from the return
of one measurement (or the campaign's start) to the next call (numpy's
linear interpolation)."""

import numpy as np


def read(run):
    waits = [w for j in run.plain_jobs if "waits" in j for w in j["waits"]]
    return 1e3 * float(np.percentile(waits, 95)) if waits else None
