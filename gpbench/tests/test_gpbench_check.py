"""The check that decides ``correct``: the references agree with the port
on small problems on the CPU, every fault a cell can have is caught by a
run of the harness (everything but its look for a card), and, on the
card, the control (the reference one precision below the configuration's)
fails the cell's limits at the cell's own size."""

import copy
import time

import numpy as np
import pytest
import torch

from gpbench.harness import bench, faults, traffic

SPEC = bench.load_spec()
CPU = torch.device("cpu")


def _small(cell, **extra):
    _, _, mix, _ = bench.cell(SPEC, cell)
    mix = copy.deepcopy(mix)
    if mix["loop"] == "recon":
        mix["field"]["shape"] = [32, 32]
        mix["iterations"] = 30
    else:
        mix.update(exploration_steps=4, gp_iterations=20,
                   refit_iterations=5)
    mix.update(extra)
    return mix


def _run(cell, mix, seed=2 ** 31 + 7, **config):
    _, cfg, _, _ = bench.cell(SPEC, cell)
    result, checks, failures = bench.run_cell(
        SPEC, cell, seed, 0.5, 0, CPU, time.perf_counter(), mix=mix,
        config=dict(cfg, **config))
    return result, checks


@pytest.mark.parametrize("cell,precision,tol", [
    ("spiral128_recon", "double", 1e-8),
    ("spiral128_recon", "single", 1e-3),
    ("bo25_ei", "double", 1e-9)])
def test_reference_agrees_with_the_port(cell, precision, tol):
    """On small problems on the CPU the port and the reference agree: to
    rounding in float64, where the run is also correct, and to ``tol`` in
    float32."""
    result, checks = _run(cell, _small(cell), precision=precision)
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["correct"] or precision == "single"
    assert max(v for v, _ in checks.values()) < tol, checks


def test_result_line_keys():
    result, _ = _run("bo25_ei", _small("bo25_ei"))
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(result)
    # on the CPU no device trace is taken, and its metrics are left out
    e2e = {m["name"]: m["source"]
           for m in bench.metrics_for(SPEC, "bo25_ei", "end_to_end")}
    assert set(result["metrics"]) == {k for k, v in e2e.items()
                                      if v != "device_trace"}
    assert "setup_s" in result["metrics"]


FAULTS = {
    "spiral128_recon": ["adam_unchanged", "half_rows", "mean_shift"],
    "bo25_ei": ["adam_unchanged", "half_rows", "mean_shift", "choice_swap"],
}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c, fs in FAULTS.items() for f in fs])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    with faults.FAULTS[fault]():
        result, checks = _run(cell, _small(cell))
    assert result["correct"] is False, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["spiral128_recon", "bo25_ei"])
def test_control_fails_the_limits_on_the_card(cell, card):
    """The reference, one precision below the configuration's, in the
    program's place at the cell's own size: some number exceeds its
    limit, or the control gives no answer."""
    w, config, mix, limits = bench.cell(SPEC, cell)
    loop = bench.make_loop(config, mix, card)
    job = loop.make_job(2 ** 31 + 99, traffic.WINDOW, 0)
    try:
        rec = loop.control(job, card)
    except RuntimeError:            # torch.linalg errors: no answer
        return
    numbers = loop.judge(job, rec, card)
    assert any(v > limits.get(k, 0.0) or not np.isfinite(v)
               for k, v in numbers.items()), numbers
