"""
The benchmark's one traffic generator: it reads a mix's parameters (a JSON
file under ``gpbench/traffic/``) and makes each job's inputs from the run's
seed and the job's index, in numpy, so that no two jobs of a run share
inputs and one seed always gives the same jobs.

A job's random stream is ``numpy.random.default_rng([seed, purpose,
index])``: purpose 0 for the window's jobs, 1 for the warm-up job, 2 for
the draw of the jobs whose answers are checked. Every job of a mix has the
same sizes; only the values and the measured pixels' places change.

The parts of a job are found by their ``kind``, a module each
(:func:`gpbench.harness.find.load`):
- ``fields/<kind>.py``: ``make(shape, params, rng)``, the field;
- ``scans/<kind>.py``: ``keep(shape, params, rng)``, the measured pixels
  (a bool grid);
- ``targets/<kind>.py``: ``value(params, idx)``, a campaign's target at a
  grid index.
"""

import numpy as np

from gpbench.harness import find

__all__ = ["job_rng", "recon_job", "campaign_job", "target_value"]

WINDOW, WARMUP, SAMPLE = 0, 1, 2


def job_rng(seed, purpose, index):
    """The random stream of one job; ``seed`` may be any non-negative
    integer."""
    return np.random.default_rng([int(seed), int(purpose), int(index)])


def recon_job(mix, seed, purpose, index):
    """{"R": the scan, NaN where not measured} of one reconstruction job:
    the mix's ``field``, plus ``noise`` times white noise, under its
    ``scan``."""
    rng = job_rng(seed, purpose, index)
    field, scan = mix["field"], mix["scan"]
    shape = tuple(field["shape"])
    R = find.load("fields", field["kind"]).make(shape, field, rng)
    R = R + mix.get("noise", 0.0) * rng.standard_normal(shape)
    R[~find.load("scans", scan["kind"]).keep(shape, scan, rng)] = np.nan
    return {"R": R}


def target_value(target, idx):
    """The campaign's target at grid index ``idx``."""
    return float(find.load("targets", target["kind"]).value(target, idx))


def campaign_job(mix, seed, purpose, index):
    """{"seed_grid": the grid, NaN but at ``seed_pixels`` distinct pixels
    measured from the target} of one campaign."""
    rng = job_rng(seed, purpose, index)
    shape = tuple(mix["grid"])
    grid = np.full(shape, np.nan)
    flat = rng.choice(int(np.prod(shape)), int(mix["seed_pixels"]),
                      replace=False)
    for i in flat:
        idx = np.unravel_index(int(i), shape)
        grid[idx] = target_value(mix["target"], idx)
    return {"seed_grid": grid}
