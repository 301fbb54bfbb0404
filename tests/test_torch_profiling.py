"""
The span recorder and the device-wait counter of
``gpim_tpu_torch.utils.profiling``: off, a shared no-op that records
nothing; on, spans nested by their parents, the per-name summary, the
spans as the profiler's annotations; the wait counts of a reconstruction
job, of a Bayesian-optimisation step and inside every Adam step, pinned
as exact integers; the masked-lattice SKI engine's segments,
preconditioner builds, CG exit checks and prediction, with answers
bit-equal with the recorder on and off; and the readers of
``tools/span_report.py`` on small CPU runs of the benchmark's loops. On
the card, every K2/K3 kernel of a profiled job falls under an
``adam.step`` annotation, and no span adds a device event to an exact or
a masked-lattice job.

The tests marked ``cuda`` need a CUDA device and skip without one. The file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_profiling.py
"""

import collections
import contextlib
import copy
import importlib.util
import json
import pathlib
import time
import types

import numpy as np
import pytest
import torch

import gpim_tpu_torch
from gpim_tpu_torch import utils
from gpim_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "span_report", ROOT / "tools" / "span_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


span_report = _load_tool()


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _grid(shape=(16, 16), seed=3, frac=0.4):
    rng = np.random.RandomState(seed)
    R = np.exp(-((np.arange(shape[0])[:, None] - 6.0) ** 2
                 + (np.arange(shape[1])[None, :] - 9.0) ** 2) / 40.0)
    R[rng.rand(*shape) > frac] = np.nan
    return R


def _model(R, **kw):
    return gpim_tpu_torch.reconstructor(
        utils.get_sparse_grid(R), R, utils.get_full_grid(R), iterations=3,
        use_gpu=False, verbose=0, **kw)


def _names(rec):
    return [s.name for s in rec.spans]


def _ancestors(rec, s):
    while s.parent is not None:
        s = rec.spans[s.parent]
        yield s


# --------------------------------------------------------------------------
# The recorder
# --------------------------------------------------------------------------

def test_off_records_nothing_and_returns_the_shared_no_op():
    assert profiling._REC is None
    ctx = profiling.span("recon.train", step=1)
    assert ctx is profiling._OFF
    assert profiling.wait("upload", 3) is profiling._OFF
    with profiling.span("bo.step", cpu=True) as s:
        assert s is None
    # a job with the recorder off leaves no recorder behind, and under a
    # profiler no span opens an annotation
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _model(_grid()).run()
    assert profiling._REC is None
    assert not [e.name for e in prof.events()
                if e.name.startswith(span_report.PROGRAM_PREFIXES)]


def test_on_nests_spans_with_their_parents():
    with profiling.spans() as rec:
        with profiling.span("bo.step", cpu=True, step=4) as outer:
            assert outer.attrs == {"step": 4}
            with profiling.span("engine.train"):
                with profiling.span("adam.step"):
                    pass
                with profiling.span("adam.step"):
                    pass
            with profiling.wait("readback", 3):
                pass
        with profiling.span("bo.step", step=5):
            pass
    assert profiling._REC is None
    assert _names(rec) == ["bo.step", "engine.train", "adam.step",
                           "adam.step", "wait.readback", "bo.step"]
    assert [s.id for s in rec.spans] == list(range(6))
    assert [s.parent for s in rec.spans] == [None, 0, 1, 1, 0, None]
    assert rec.counts == {"readback": 3}
    first = rec.spans[0]
    assert first.attrs["step"] == 4 and first.attrs["cpu_ns"] >= 0
    assert rec.spans[5].attrs == {"step": 5}
    for s in rec.spans:
        assert s.end_ns >= s.start_ns
        for a in _ancestors(rec, s):
            assert a.start_ns <= s.start_ns and s.end_ns <= a.end_ns
    s = rec.summary()
    assert s["adam.step"]["calls"] == 2 and s["adam.step"]["warm_s"] >= 0
    assert s["engine.train"] == {
        "calls": 1, "warm_s": None, "first_s": pytest.approx(
            (rec.spans[1].end_ns - rec.spans[1].start_ns) * 1e-9)}


def test_a_block_inside_another_records_into_its_own_recorder():
    with profiling.spans() as outer:
        with profiling.span("recon.train"):
            with profiling.spans() as inner:
                with profiling.span("adam.step"):
                    pass
            with profiling.span("adam.step"):
                pass
    assert _names(outer) == ["recon.train", "adam.step"]
    assert _names(inner) == ["adam.step"] and inner.spans[0].parent is None
    assert profiling._REC is None


def test_a_span_closes_when_its_block_raises():
    with profiling.spans() as rec:
        with pytest.raises(ValueError):
            with profiling.span("recon.predict"):
                raise ValueError("x")
        with profiling.span("recon.train"):
            pass
    assert [s.parent for s in rec.spans] == [None, None]


def test_trace_carries_the_spans_as_annotations(tmp_path):
    """utils.profiling.trace switches the recorder on for its block: the
    Chrome trace holds the program's spans as user annotations."""
    model = _model(_grid())
    with profiling.trace(str(tmp_path)):
        model.train()
    assert profiling._REC is None
    (path,) = tmp_path.glob("*.pt.trace.json")
    notes = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    for name in ("recon.train", "engine.train", "adam.step",
                 "wait.cholesky", "wait.traj"):
        assert name in notes
    assert notes.count("adam.step") == 3


# --------------------------------------------------------------------------
# The wait counts
# --------------------------------------------------------------------------

def _no_wait_in_an_adam_step(rec):
    waits = [s for s in rec.spans if s.name.startswith("wait.")]
    assert waits
    for w in waits:
        assert "adam.step" not in [a.name for a in _ancestors(rec, w)]


def test_wait_counts_of_a_reconstruction_job():
    """A job of the spiral cell's form (constructor, train, predict) at a
    small size: the four bounds, three parameters and three training
    tensors uploaded, one Cholesky check a phase, the trajectory's four
    series and the two predicted series read back; none inside an Adam
    step."""
    R = _grid((24, 24))
    with profiling.spans() as rec:
        model = _model(R)
        model.train()
        model.predict()
    assert rec.counts == {"upload": 11, "cholesky": 2, "traj": 4,
                          "readback": 2}
    _no_wait_in_an_adam_step(rec)
    tops = [s.name for s in rec.spans if s.parent is None]
    assert tops == ["recon.init", "recon.train", "recon.predict"]
    assert _names(rec).count("adam.step") == 3
    chunks = [s for s in rec.spans if s.name == "predict.chunk"]
    assert len(chunks) == 1
    assert rec.spans[chunks[0].parent].name == "engine.predict"
    # the counts repeat, whatever the data
    with profiling.spans() as again:
        model = _model(_grid((40, 40), seed=9, frac=0.7))
        model.train()
        model.predict()
    assert again.counts == rec.counts


def _bo(steps=3):
    from gpim_tpu_torch import boptimizer
    R = _grid((12, 12), frac=0.05)
    R[3, 4] = 0.5
    truth = _grid((12, 12), frac=2.0)
    return boptimizer(
        utils.get_sparse_grid(R), R, utils.get_full_grid(R),
        lambda idx: float(truth[idx]), acquisition_function="ei",
        exploration_steps=steps, gp_iterations=4, refit_iterations=2,
        use_gpu=False, verbose=0, filename=None)


def test_wait_counts_of_a_fused_bo_step():
    """One step of the device path: the training set's three tensors and
    the observed mask uploaded, the refit's and the predict's Cholesky
    checks, and the three top-k series read back; the step's phases in
    order, every one a child of ``bo.step``."""
    bo = _bo()
    bo.single_step(0)
    with profiling.spans() as rec:
        bo.single_step(1)
    assert rec.counts == {"upload": 4, "cholesky": 2, "readback": 3}
    _no_wait_in_an_adam_step(rec)
    (step,) = [s for s in rec.spans if s.name == "bo.step"]
    assert step.attrs["step"] == 1 and step.attrs["measured"] == 1
    assert step.attrs["cpu_ns"] > 0
    children = [s.name for s in rec.spans if s.parent == step.id]
    assert children == ["bo.update", "wait.upload", "engine.train",
                        "engine.predict", "bo.rank", "bo.select",
                        "bo.measure", "bo.record"]
    assert _names(rec).count("adam.step") == 2


def test_a_campaign_counts_its_read_backs_at_the_end(tmp_path):
    """``run()``: the constructor's uploads, three steps, the trailing
    refit, and the read-back of the predictions and trajectories that
    stayed on the device."""
    with profiling.spans() as rec:
        bo = _bo()
        bo.filename = str(tmp_path / "bo")
        bo.run()
    # constructor: 4 bounds, 3 parameters, 3 training tensors, the test
    # grid and the selection mask; 3 steps of 9; the trailing refit's 3
    # uploads and 1 check; 3 predictions of 2 series and 4 trajectories
    # of 4 series
    assert rec.counts == {"upload": 12 + 3 * 4 + 3, "cholesky": 3 * 2 + 1,
                          "readback": 3 * 3,
                          "materialize": 3 * 2 + 4 * 4}
    tops = [s.name for s in rec.spans if s.parent is None]
    assert tops == (["recon.init", "wait.upload", "wait.upload"]
                    + ["bo.step"] * 3 + ["bo.refit_tail"]
                    + ["wait.materialize"] * 4)


# --------------------------------------------------------------------------
# The masked-lattice SKI engine
# --------------------------------------------------------------------------

def _cube(shape=(8, 7, 5), seed=4):
    """A smooth cube with noise and half of its (x, y) spectra removed."""
    rng = np.random.RandomState(seed)
    x, y, z = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                          indexing="ij")
    R = np.sin(x / 3.0) * np.cos(y / 4.0) + 0.3 * np.sin(z / 2.0)
    R = R + 0.02 * rng.randn(*shape)
    sites = rng.choice(shape[0] * shape[1], shape[0] * shape[1] // 2,
                       replace=False)
    R.reshape(-1, shape[2])[sites] = np.nan
    return R


def _ski_job(R, recorder, device=CPU, **kw):
    """A masked-lattice job (constructor, train, predict); returns (the
    model, mean, sd, the recorder or None)."""
    with profiling.spans() if recorder else contextlib.nullcontext() as rec:
        model = gpim_tpu_torch.skreconstructor(
            utils.get_sparse_grid(R), R, utils.get_full_grid(R),
            kernel="RBF", ski=True, learning_rate=0.1, iterations=12,
            use_gpu=device.type == "cuda", verbose=0, ski_min_points=1,
            precond_rank=16, **kw)
        mean, sd = model.run()[:2]
    assert model._mgrid_engine is not None
    return model, mean, sd, rec


def _exit_checks(realized, cap=64):
    """The host reads of CG's exit test in a solve of ``realized``
    iterations under ``cap``: one every CG_EXIT_CHECK_EVERY iterations
    until the first that finds every column converged."""
    from gpim_tpu_torch.ops.ski import CG_EXIT_CHECK_EVERY as every
    return min(max(1, -(-int(realized) // every)), (cap - 1) // every)


def test_ski_spans_nest_and_count_the_reads():
    """A masked-lattice job: the optimizer's construction, every segment
    (with its steps), its preconditioner build, its Adam steps and its one
    read nest under ``recon.train``, the CG exit checks inside the steps,
    the read of the realized iterations after the segments, and the
    prediction's solve and variance under ``recon.predict``; the waits
    are the reads that the realized CG iterations imply."""
    model, _, _, rec = _ski_job(_cube(), True)
    eng = model._mgrid_engine
    segments, its = eng.last_segments, eng.last_cg_iters
    by_id = {s.id: s for s in rec.spans}

    def parent(s):
        return by_id[s.parent].name if s.parent is not None else None
    (train,) = [s for s in rec.spans if s.name == "recon.train"]
    assert train.attrs == {}
    kids = [s for s in rec.spans if s.parent == train.id]
    assert [s.name for s in kids] == (["adam.init"]
                                      + ["ski.segment"] * len(segments)
                                      + ["wait.cg_iters"])
    assert [s.attrs["steps"] for s in kids[1:-1]] == segments
    for seg in kids[1:-1]:
        inner = [s.name for s in rec.spans if s.parent == seg.id]
        assert inner == (["ski.precond"] + ["adam.step"] * seg.attrs["steps"]
                         + ["wait.segment"])
    assert {parent(s) for s in rec.spans if s.name == "wait.cg_exit"} == {
        "adam.step", "ski.predict.solve"}
    (solve,) = [s for s in rec.spans if s.name == "ski.predict.solve"]
    (var,) = [s for s in rec.spans if s.name == "ski.predict.var"]
    assert parent(solve) == parent(var) == "recon.predict"
    assert solve.attrs == var.attrs == {}
    assert rec.counts == {
        "upload": 2, "segment": len(segments), "cg_iters": 1,
        "cg_exit": sum(_exit_checks(c) for c in its)
        + _exit_checks(eng.last_predict_cg_iters)}


def test_ski_answers_are_bit_equal_with_the_recorder_on_and_off():
    R = _cube(seed=6)
    off, mean0, sd0, _ = _ski_job(R, False)
    on, mean1, sd1, _ = _ski_job(R, True)
    np.testing.assert_array_equal(mean0, mean1)
    np.testing.assert_array_equal(sd0, sd1)
    for k in ("lengthscale", "noise"):
        np.testing.assert_array_equal(off.hyperparams[k], on.hyperparams[k])
    np.testing.assert_array_equal(off.losses, on.losses)
    np.testing.assert_array_equal(off._mgrid_engine.last_cg_iters,
                                  on._mgrid_engine.last_cg_iters)


# --------------------------------------------------------------------------
# The readers of tools/span_report.py
# --------------------------------------------------------------------------

def _small(cell):
    from gpbench.harness import bench
    _, _, mix, _ = bench.cell(bench.load_spec(), cell)
    mix = copy.deepcopy(mix)
    if mix["loop"] == "recon":
        mix["field"]["shape"] = [24, 24]
        mix.update(iterations=6, warmup_iterations=2)
    else:
        mix.update(exploration_steps=3, gp_iterations=6, refit_iterations=3)
    return mix


@pytest.mark.parametrize("cell", ["spiral128_recon", "bo25_ei"])
@pytest.mark.parametrize("recorder", [1, 0])
def test_readers_on_a_small_cpu_run(cell, recorder):
    """With the recorder on, every reader of the cell's loop but the one
    that reads the device trace gives a number; with it off, none does."""
    mix = _small(cell)
    result, run, _, _ = span_report.run_spanned(
        cell, 2 ** 31 + 11, 0.3, 0, CPU, recorder=recorder, mix=mix)
    assert result["failed"] == 0 and result["correct"]
    names = span_report.SPANNED[mix["loop"]]
    got = {n: span_report.READERS[n](run) for n in names}
    if not recorder:
        assert got == dict.fromkeys(names) and not result["span_metrics"]
        return
    assert got.pop("idle_in_refit_pct.bo", None) is None   # no card trace
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    assert result["span_metrics"] == got
    if cell == "bo25_ei":
        # constructor 12, a step 9, the trailing refit 4, read-backs
        # 2 a prediction and 4 a trajectory
        assert got["syncs_per_step.bo"] == (12 + 3 * 9 + 4 + 3 * 2
                                            + 4 * 4) / 3
        # the four parts of a step fall inside its wall clock
        parts = sum(got[k] for k in (
            "bo_refit_ms_per_step", "bo_rank_ms_per_step",
            "bo_host_loop_ms_per_step", "bo_measure_ms_per_step"))
        wall = 1e3 * sum(j["clock_s"] for j in run.plain_jobs) / sum(
            j["steps"] for j in run.plain_jobs)
        assert 0 < parts < wall
    else:
        assert got["syncs_per_job.recon"] == 19
    assert got["first_step_s"] < 60


def _event(name, start, end, cuda=False, note=False):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        is_user_annotation=note)


def test_idle_gaps_by_the_innermost_span():
    """The idle seconds between device operations go to the innermost
    program span open at each gap's midpoint; a gap inside an Adam step
    of a refit counts toward the refit's idle share, torch.optim's own
    annotations are not program spans, and a gap outside every span is
    labelled so."""
    from gpbench.harness import trace
    events = [
        _event("bo.step", 0, 1000, note=True),
        _event("engine.train", 0, 600, note=True),
        _event("adam.step", 0, 300, note=True),
        _event("Optimizer.step#Adam.step", 200, 290, note=True),
        _event("adam.step", 300, 600, note=True),
        _event("bo.rank", 700, 900, note=True),
        _event("aten::mm", 10, 20),
        _event("k", 100, 150, cuda=True),
        _event("k", 250, 280, cuda=True),     # gap 150-250, mid 200
        _event("k", 420, 440, cuda=True),     # gap 280-420, mid 350
        _event("k", 800, 810, cuda=True),     # gap 440-800, mid 620
        _event("k", 1500, 1510, cuda=True),   # gap 810-1500, mid 1155
        _event("gpu_note", 100, 1000, cuda=True, note=True),
    ]
    out = trace.Trace()
    span_report.reduce_with_spans(events, out, trace.reduce_events)
    assert out.launches == 5
    assert [s[2] for s in out.spans] == [
        "bo.step", "engine.train", "adam.step", "adam.step", "bo.rank"]
    gaps = dict(out.idle_gaps_by_span)
    assert gaps == pytest.approx({"adam.step": 240e-6, "bo.step": 360e-6,
                                  span_report._OUTSIDE: 690e-6})
    assert out.idle_s == pytest.approx(1290e-6)
    run = types.SimpleNamespace(trace=out)
    assert span_report.idle_in_refit_pct_bo(run) == pytest.approx(
        100 * 240 / 1290)
    assert span_report.idle_in_refit_pct_bo(
        types.SimpleNamespace(trace=None)) is None


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _profiled_job(R, recorder):
    from torch.profiler import ProfilerActivity, profile
    model = gpim_tpu_torch.reconstructor(
        utils.get_sparse_grid(R), R, utils.get_full_grid(R), kernel="RBF",
        iterations=5, precision="double", verbose=0)
    torch.cuda.synchronize()
    with profiling.spans() if recorder else contextlib.nullcontext():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(profiling.EDGE_S)
            model.train()
            model.predict()
            torch.cuda.synchronize()
            time.sleep(profiling.EDGE_S)
    return prof


@pytest.mark.cuda
def test_kernels_fall_under_adam_steps_and_spans_add_no_device_event(
        dev, tmp_path):
    """A profiled reconstruction job on the card: the launch of every K2
    and K3 kernel lies inside an ``adam.step`` annotation, and with the
    recorder on the job runs no device operation that it does not run
    with the recorder off, and as many K2 and K3 kernels. (The profiler
    can lose the first few device events of a window, so events missing
    from one side are not compared.)"""
    R = _grid((48, 48), frac=0.5)
    _profiled_job(R, True)                   # the library, the handles
    kinds = ("kernel", "gpu_memcpy", "gpu_memset")
    seen = {}
    for on in (False, True):
        prof = _profiled_job(R, on)
        path = tmp_path / ("%d.json" % on)
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        device = [e for e in events if e.get("cat") in kinds]
        seen[on] = collections.Counter(e["name"] for e in device)
        if not on:
            continue
        steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") == "user_annotation"
                       and e["name"] == "adam.step")
        assert len(steps) == 5, steps
        launch = {e["args"]["correlation"]: e["ts"] for e in events
                  if e.get("cat") == "cuda_runtime"
                  and "correlation" in e.get("args", {})}
        ours = [e for e in device if "masked_system_kernel" in e["name"]
                or "rbf_bwd_kernel" in e["name"]]
        assert len(ours) == 10, [e["name"] for e in ours]
        for e in ours:
            t = launch.get(e["args"].get("correlation"))
            assert t is not None and any(a <= t <= b for a, b in steps), (
                e, t, steps)
    assert not seen[True] - seen[False], seen[True] - seen[False]
    for name in ("masked_system_kernel", "rbf_bwd_kernel"):
        assert [sum(n for k, n in seen[on].items() if name in k)
                for on in (False, True)] == [5, 5]


@pytest.mark.cuda
def test_ski_spans_add_no_device_event(dev, tmp_path):
    """A profiled masked-lattice job on the card (float32, 24x24x16, half
    the spectra left out): with the recorder on it runs no device
    operation that it does not run with the recorder off, and as many K1
    kernels; the training's realized CG iterations are the same. (The
    profiler can lose the first few device events of a window, so events
    missing from one side are not compared.)"""
    from torch.profiler import ProfilerActivity, profile
    R = _cube((24, 24, 16), seed=8)
    _ski_job(R, False, dev, precision="single")    # handles, first Adam
    kinds = ("kernel", "gpu_memcpy", "gpu_memset")
    seen, its = {}, {}
    for on in (False, True):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(profiling.EDGE_S)
            model = _ski_job(R, on, dev, precision="single")[0]
            torch.cuda.synchronize()
            time.sleep(profiling.EDGE_S)
        its[on] = model._mgrid_engine.last_cg_iters.tolist()
        path = tmp_path / ("%d.json" % on)
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        seen[on] = collections.Counter(e["name"] for e in events
                                       if e.get("cat") in kinds)
    assert its[True] == its[False]
    assert not seen[True] - seen[False], seen[True] - seen[False]
    k1 = [sum(n for k, n in seen[on].items() if "sqdist_kernel" in k)
          for on in (False, True)]
    assert k1[0] == k1[1] > 0, k1
