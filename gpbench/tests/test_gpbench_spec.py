"""BENCHMARK.json against the benchmark's contract, the files it names,
the traffic generator, the frozen arithmetic of the metrics, and the
harness's imports."""

import ast
import json
import os
import re

import numpy as np
import pytest

from gpbench.harness import bench, find, traffic

ROOT = bench.ROOT
HERE = bench.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = bench.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _metric_module(name):
    return find.load("metrics", name)


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert SPEC["paths"] == ["gpbench"]
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [x["name"] for x in SPEC[kind]]
    assert len(names) == len(set(names))
    for x in SPEC[kind]:
        assert NAME.match(x["name"]), x["name"]
        if "unit" in x:
            assert UNIT.match(x["unit"]), x["unit"]
            assert x["better"] in ("lower", "higher")
            assert x["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        for key in ("why", "layer", "source"):
            if key in x:
                assert 1 <= len(x[key]) <= 200 and "\n" not in x[key]
    if kind == "workloads":
        pairs = [(w["config"], w["traffic"]) for w in SPEC[kind]]
        assert len(pairs) == len(set(pairs))
        for w in SPEC[kind]:
            assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_moves_is_reported_by_every_cell_of_the_metric(metric):
    m = {x["name"]: x for x in SPEC["per_layer"]}[metric]
    e2e = {x["name"]: x for x in SPEC["end_to_end"]}[m["moves"]]
    for cell in m.get("workloads", CELLS):
        assert cell in e2e.get("workloads", CELLS)


def test_every_cell_reports_setup_another_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in bench.metrics_for(SPEC, cell,
                                                    "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.metrics_for(SPEC, cell, "per_layer")


@pytest.mark.parametrize("cell", CELLS)
def test_files_resolve_by_name(cell):
    w, config, mix, limits = bench.cell(SPEC, cell)
    assert callable(find.load("loops", mix["loop"]).Loop)
    ref = find.load("reference", config["reference"])
    assert callable(ref.train) and callable(ref.predict)
    assert callable(find.entry(config["entry"][mix["loop"]]))
    for key, kind, fn in (("field", "fields", "make"),
                          ("scan", "scans", "keep"),
                          ("target", "targets", "value")):
        if key in mix:
            assert callable(getattr(find.load(kind, mix[key]["kind"]), fn))
    assert limits and all(v > 0 for v in limits.values())
    cfg = {c["name"]: c for c in SPEC["configs"]}[w["config"]]
    assert cfg["file"].startswith("gpbench/")
    assert config["reduced"] == cfg["reduced"]


def test_a_missing_part_is_named():
    with pytest.raises(FileNotFoundError, match="loops"):
        find.load("loops", "no_such_loop")


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_exists(metric):
    assert callable(_metric_module(metric).read)


def test_every_config_is_used():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("cell", CELLS)
def test_jobs_repeat_from_a_seed(cell):
    _, _, mix, _ = bench.cell(SPEC, cell)
    make = (traffic.campaign_job if mix["loop"] == "campaign"
            else traffic.recon_job)
    seed = 2 ** 31 + 12345          # the driver's seeds pass 32 bits
    a = make(mix, seed, traffic.WINDOW, 3)
    b = make(mix, seed, traffic.WINDOW, 3)
    c = make(mix, seed, traffic.WINDOW, 4)
    key = "seed_grid" if "seed_grid" in a else "R"
    np.testing.assert_array_equal(a[key], b[key])
    assert not np.array_equal(np.nan_to_num(a[key]), np.nan_to_num(c[key]))
    # every job has the same sizes
    assert np.isnan(a[key]).sum() == np.isnan(c[key]).sum()


def test_spiral_scan_size():
    _, _, mix, _ = bench.cell(SPEC, "spiral128_recon")
    R = traffic.recon_job(mix, 1, traffic.WINDOW, 0)["R"]
    assert R.shape == (128, 128) and int((~np.isnan(R)).sum()) == 6036


@pytest.mark.parametrize("name,kernel", [
    ("k2_roofline_pct", "masked_system"),
    ("k3_roofline_pct", "rbf_bwd_reductions")])
def test_frozen_traffic_matches_the_program(name, kernel):
    from gpim_tpu_torch.ops import gram_kernels
    mod = _metric_module(name)
    for n, itemsize in ((6036, 4), (35, 8)):
        rd, wr, ops = gram_kernels.min_traffic(kernel, n, 2,
                                               itemsize=itemsize)
        assert mod.traffic(n, 2, itemsize) == (rd + wr, ops)
    # the spiral's bound: bytes, 0.0870 ms at n = 6036
    nbytes, ops = mod.traffic(6036, 2, 4)
    assert max(nbytes / mod.PEAK_BYTES_PER_S,
               ops / mod.PEAK_OPS_PER_S[4]) == pytest.approx(8.70e-5,
                                                             rel=2e-3)


def test_exact_mfu_operations():
    mod = _metric_module("exact_mfu")
    assert mod.operations(250, 6036, 0) == pytest.approx(5.498e13, rel=1e-3)
    assert mod.operations(0, 6036, 16384) == pytest.approx(
        2 * 16384 * 6036 ** 2)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        for top in _imports(path):
            assert top not in bench.FORBIDDEN, (path, top)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for top in _imports(path):
            assert top in ("contextlib", "math", "numpy", "torch"), (
                path, top)


def test_forbidden_modules_are_compared_whole(monkeypatch):
    import sys
    for loaded, found in (
            (["gpim_tpu_torch", "gpim_tpu_torch.ops", "jaxtyping"], []),
            (["gpim_tpu_torch", "jax.numpy", "gpim_tpu.ops"],
             ["gpim_tpu", "jax"])):
        monkeypatch.setattr(sys, "modules", dict.fromkeys(loaded))
        got = bench.forbidden_modules()
        monkeypatch.undo()
        assert got == found


def test_busy_time_is_the_union_of_the_device_intervals():
    from gpbench.harness import trace
    busy, gaps = trace.busy_intervals([(5, 7), (0, 2), (1, 3), (10, 11)])
    assert busy == 3 + 2 + 1 and gaps == [(3, 5), (7, 10)]


def test_device_time_per_step_reads_the_whole_window():
    from gpbench.harness import trace
    run = bench.Run({}, {})
    run.jobs = [{"waits": [0.1], "steps": 30, "clock_s": 5.0},
                {"waits": [0.2], "steps": 30, "clock_s": 6.0}]
    read = _metric_module("bo_device_ms_per_step").read
    assert read(run) is None
    run.window_trace = trace.Trace()
    run.window_trace.busy_s = 0.9
    assert read(run) == pytest.approx(15.0)
