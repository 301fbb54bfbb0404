#!/usr/bin/env python3
"""
Smoke run of gpim_tpu_torch on one CUDA card: the quickest proof that the
port builds, that its kernels agree with their plain PyTorch versions, and
that its main path runs through them.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero without
its final line):

1. device  - require CUDA; print the card, its power limit, torch/CUDA.
2. build   - compile csrc/gram_kernels.cu with nvcc; print the seconds.
3. kernels - K1/K2/K3 against their plain versions (evaluated in float64
             on the same inputs), in float32 and float64, at the flagship's
             shapes, and K1 also at the three shapes of the VFE path (Kmn,
             Kmm, one predict chunk's Ks), with the tolerances below;
             float32 device time per call of each kernel, its plain version
             and (K1) torch.cdist, beside the kernel's bound: K2 and K3 from
             a warm loop of launches (_time_ms), K1 from a CUDA graph of
             calls (_time_graph_ms).
4. flagship - reconstructor(X, R, X_full, kernel="RBF", iterations=250,
             precision="single").run() on the 128x128 spiral
             (examples/_data.spiral_scan, n = 6144 padded training rows,
             16384 test points), cold then warm, built without use_gpu;
             rmse at the observed pixels < 0.1, no NaN, every kernel
             launched, every model tensor on the card.
5. vfe     - the BEPFM 3D sparse workflow (examples/hyperspectral_3d_sparse
             .py, benchmarks/suite.py bench_bepfm_3d_sparse):
             reconstructor(X, R, X_full, kernel="Matern52", sparse=True,
             indpoints=1000, learning_rate=0.05, iterations=400,
             precision="single").run() on the 32x32x102 cube with 70.6% of
             its spectra removed (n = 30848 padded rows, d = 3, m = 1027
             inducing points, 104448 test points), cold then warm, built
             without use_gpu; rmse against the full cube < 0.1, no NaN, K1
             launched, every model tensor on the card.
6. cross-check - the flagship and the VFE run in float64 (at the float32
             jitter) on the card against their float32 runs; and small exact
             and sparse problems on the card against the CPU path.
7. profile - torch.profiler over PROFILE_STEPS warm float32 training steps
             of the flagship and of the VFE run: device ms per step by
             kernel and the device's idle share (printed; a profiler that
             records no device time prints "not measured" and fails
             nothing).

Prints the kernels as one JSON line, then as its last line
{"ok": true, "device": {...}}.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
sys.path.insert(0, os.path.join(_HERE, "examples"))

ITERATIONS = 250
VFE = dict(kernel="Matern52", sparse=True, indpoints=1000,
           learning_rate=0.05, iterations=400)
TIMING_REPS = 50
# NVIDIA H100 SXM data sheet: HBM3 rate, and peaks outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
SOURCE = "gpim_tpu_torch/csrc/gram_kernels.cu"
# Normalized max error |kernel - plain_f64| / scale, set beforehand from
# the rounding of each kernel's arithmetic (see gram_kernels docstrings).
TOL = {
    "sqdist": {"float32": 1e-6, "float64": 1e-14},
    "masked_system": {"float32": 4e-6, "float64": 1e-13},
    "rbf_bwd_reductions": {"float32": 1e-4, "float64": 1e-12},
}
# f32 flagship vs f64 flagship at the same jitter. Measured on an H100:
# mean 7.9e-4, sd 4.9e-4, noise 2.1e-8 apart, so those limits are tightened
# from tests/test_gpr.py:174-178 (5e-3, 5e-3, 1e-3). The final lengthscale
# differs by 2.06e-2: on this noise-free synthetic scan the likelihood is
# flat in the lengthscale and 250 Adam steps have not converged, so f32
# rounding moves where the run stops along that ridge, while the
# prediction agrees to < 1e-3. Its limit is 5e-2.
CROSS_TOL = {"mean_atol": 2e-3, "sd_atol": 2e-3, "ls_rtol": 5e-2,
             "noise_atol": 1e-6}
# f32 VFE run vs f64 VFE run at the same jitter. The VFE trains 1027 x 3
# inducing-point coordinates with the hyperparameters, and 400 Adam steps
# amplify f32 rounding: on an H100 the two runs ended with inducing points
# up to 16 grid units apart, mean 5.8e-2, sd 2.3e-2, lengthscale 5.5% and
# noise 18% apart, while both reached rmse_vs_truth ~0.02 (0.0224 vs
# 0.0195). So the end points are held to about twice those gaps, and
# precision itself by what stays on one path: the loss at step 0 (same
# parameters; 1.4e-7 apart) and a prediction in f64 from the f32 run's
# final parameters against the f32 prediction ("same_u_*"; mean 1.8e-3
# and sd 1.1e-5 apart, the mean through the f32 Cholesky of Kmm at jitter
# 1e-4), each held to a few times its measured gap.
VFE_CROSS_TOL = {"mean_atol": 1.2e-1, "sd_atol": 5e-2, "ls_rtol": 1.2e-1,
                 "noise_rtol": 4e-1, "rmse_diff": 1e-2, "loss0_rtol": 1e-6,
                 "same_u_mean_atol": 5e-3, "same_u_sd_atol": 1e-4}
SMALL_RTOL = 1e-7          # small problems, CUDA vs CPU, float64
PROFILE_STEPS = 10


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def flagship_data():
    import _data
    from gpim_tpu_torch import utils
    R = _data.spiral_scan()
    return R, utils.get_sparse_grid(R), utils.get_full_grid(R)


def vfe_data():
    import _data
    from gpim_tpu_torch import utils
    R = _data.bepfm_cube(sparse=True)
    return R, utils.get_sparse_grid(R), utils.get_full_grid(R), \
        _data.bepfm_cube()


def small_data(seed=0):
    """24x24 Gaussian bump with 40% of the pixels missing."""
    rng = np.random.RandomState(seed)
    ii, jj = np.indices((24, 24))
    R = np.exp(-((ii - 9.0) ** 2 + (jj - 14.0) ** 2) / 40.0)
    R = R + 0.01 * rng.randn(24, 24)
    R[rng.rand(24, 24) < 0.4] = np.nan
    return R


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log("[device] torch %s, CUDA %s, %d device(s), python %s" % (
        torch.__version__, torch.version.cuda, torch.cuda.device_count(),
        sys.version.split()[0]))
    return card


def phase_build():
    from gpim_tpu_torch.ops import _build
    res = _build.build()
    # ptxas -v: one line per kernel (mangled name from the kernel's own
    # name on, so the template arguments show; registers, spills)
    name = spill = ""
    for line in res.log.splitlines():
        if "Function properties for" in line:
            name = re.sub(r"^.*?\d+(?=(sqdist|masked_system|rbf_bwd)_kernel)",
                          "", line.split(" for ", 1)[1].strip())
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            log("[build] %s: %s; %s" % (name[:40], line.split(":", 1)[1]
                                        .strip(), spill))
        elif "error" in line:
            log("[build] " + line.strip())
    _build.load_library()
    log("[build] %s built in %.2f s" % (res.path.name, res.seconds))
    return res.seconds


def _time_ms(fn, reps=TIMING_REPS):
    """Device ms per call: CUDA events around a warm loop of ``reps``
    calls, one synchronise at its end, the window divided by ``reps``. The
    wrappers' host work (checks, allocation, the ctypes call) then overlaps
    the device's, as it does in the training loop. The flagship's calls
    move >= 100 MB, twice the card's 50 MB L2, so each call finds cold what
    the one before it touched, as the training loop does."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _time_graph_ms(fn, reps=TIMING_REPS):
    """Device ms per call with no host time in the window: ``reps`` calls
    captured into one CUDA graph, one replay timed by CUDA events, divided
    by ``reps``. K1's VFE shapes take a few microseconds on the card, less
    than the wrapper's host work, so a loop of calls (:func:`_time_ms`)
    times the host there; every K1 time is taken this way. Its Kmm (4 MB)
    and Ks (17 MB) outputs fit in the 50 MB L2, as they do in training."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def bound(name, n, d, m=None, dtype_name="float32"):
    """(least ms, "bytes" or "operations") the card could take for one call
    at these shapes: the larger of the bytes it must move over the memory
    rate and its operations over the peak rate of their type."""
    from gpim_tpu_torch.ops.gram_kernels import min_traffic
    itemsize = 4 if dtype_name == "float32" else 8
    read, written, ops = min_traffic(name, n, d, m, itemsize)
    t_bytes = (read + written) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _norm_err(out, ref, scale):
    import torch
    err = (out.double() - ref).abs().max().item()
    return err, err / max(float(scale), torch.finfo(torch.float64).tiny)


def _check(name, dtype_name, err, nerr):
    tol = TOL[name][dtype_name]
    ok = nerr <= tol
    log("[kernels] %-19s %-7s max_abs_err %.3e  normalized %.3e  tol %.0e"
        "  %s" % (name, dtype_name, err, nerr, tol, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("%s %s disagrees with its plain version: "
                             "normalized error %.3e > %.0e"
                             % (name, dtype_name, nerr, tol))


def _sqdist_case(A, B, zeros, dname, timed):
    """K1 on (A, B) against its plain version; ``zeros`` (rows, cols) are
    coincident pairs that must come out exactly 0. Returns the record."""
    import torch
    from gpim_tpu_torch.ops import gram_kernels as gk
    out = gk.sqdist(A, B)
    ref = gk.sqdist_plain(A.double(), B.double())
    torch.cuda.synchronize()
    if not bool((out[zeros] == 0).all()):
        raise AssertionError("sqdist: coincident points are not exactly 0")
    err, nerr = _norm_err(out, ref, ref.abs().max())
    _check("sqdist", dname, err, nerr)
    rec = {"err": err, "shape": [len(A), len(B), A.shape[1]]}
    if timed:
        rec["ms"] = _time_graph_ms(lambda: gk.sqdist(A, B))
        # the same kernel timed as K2 and K3 are, host time overlapped
        rec["loop_ms"] = _time_ms(lambda: gk.sqdist(A, B))
        rec["plain_ms"] = _time_graph_ms(lambda: gk.sqdist_plain(A, B))
        # the nearest single call; it returns the root of K1's output
        rec["library_ms"] = _time_graph_ms(lambda: torch.cdist(A, B))
        rec["bound"] = bound("sqdist", len(A), A.shape[1], m=len(B),
                             dtype_name=dname)
    return rec


def _vfe_k1_inputs(vfe, dtype):
    """K1's three operand pairs on the VFE path, from the BEPFM cube at a
    trained model's lengthscales: Kmn (Xu, X), Kmm (Xu, Xu) and one predict
    chunk's Ks (test points, Xu), with their coincident pairs."""
    import torch
    from gpim_tpu_torch import utils
    from gpim_tpu_torch.gpreg import engine
    R, X, X_full, _ = vfe
    X_np, _ = utils.prepare_training_data(X, R)
    stride = len(X_np) // VFE["indpoints"]
    Xp, _ = engine.pad_rows(X_np, 128)
    ls = np.array([4.0, 4.0, 9.0])
    t = lambda a: torch.as_tensor(a / ls, dtype=dtype,  # noqa: E731
                                  device="cuda").contiguous()
    Xu, Xs = t(X_np[::stride]), t(Xp)
    Xt = t(utils.prepare_test_data(X_full)[:4096])
    Xt[:512] = Xu[:512]
    m = len(Xu)
    i = torch.arange(m, device="cuda")
    j = torch.arange(512, device="cuda")
    return [("Kmn", Xu, Xs, (i, i * stride)),
            ("Kmm", Xu, Xu, (i, i)),
            ("Ks", Xt, Xu, (j, j))]


def phase_kernels(R, X, X_full, vfe):
    """Each kernel against its plain version at the flagship's shapes, and
    K1 also at the VFE path's."""
    import torch
    from gpim_tpu_torch import utils
    from gpim_tpu_torch.gpreg import engine
    from gpim_tpu_torch.ops import gram_kernels as gk
    from gpim_tpu_torch.ops.linalg import safe_cholesky
    from gpim_tpu_torch.ops.tri import tri_inverse

    dev = torch.device("cuda")
    X_np, y_np = utils.prepare_training_data(X, R)
    Xp, n_obs = engine.pad_rows(X_np, 128)
    yp, _ = engine.pad_rows(y_np, 128)
    mask_np = np.zeros(len(Xp))
    mask_np[:n_obs] = 1.0
    Xt_np = utils.prepare_test_data(X_full)[:4096]
    ls = np.array([3.0, 2.5])          # hyperparameters of a trained model
    v, noise, jitter, rq_alpha = 0.08, 3e-3, 1e-4, 1.3
    n = len(Xp)
    log("[kernels] training rows n = %d (%d observed), test chunk %d, d = %d"
        % (n, n_obs, len(Xt_np), Xp.shape[1]))
    report = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa
        Xs = t(Xp / ls).contiguous()
        mask = t(mask_np)
        y = t(yp)

        # K1 at the predict cross-Gram shape, a coincident block included
        A1 = t(Xt_np / ls).contiguous()
        A1[:512] = Xs[:512]
        j = torch.arange(512, device=dev)
        timed = dtype == torch.float32
        rec = {"sqdist": _sqdist_case(A1, Xs, (j, j), dname, timed)}
        # K1 at the VFE path's three shapes
        rec["sqdist"]["vfe_shapes"] = {}
        for label, A, B, zeros in _vfe_k1_inputs(vfe, dtype):
            log("[kernels]   sqdist VFE %s %d x %d, d = %d"
                % (label, len(A), len(B), A.shape[1]))
            rec["sqdist"]["vfe_shapes"][label] = _sqdist_case(
                A, B, zeros, dname, timed)
        del A1, A, B

        # K2 at the training system shape, all three kernel families
        vt, njt, at = t(v), t(noise + jitter), t(rq_alpha)
        errs = []
        for kernel in ("RBF", "Matern52", "RationalQuadratic"):
            a = at if kernel == "RationalQuadratic" else None
            Kt, A = gk.masked_system(Xs, mask, vt, njt, a, kernel=kernel)
            Kr, Ar = gk.masked_system_plain(
                Xs.double(), mask.double(), vt.double(), njt.double(),
                None if a is None else a.double(), kernel=kernel)
            torch.cuda.synchronize()
            if not bool((torch.diagonal(Kt) == vt).all()):
                raise AssertionError("masked_system: diagonal is not v")
            ek, nk = _norm_err(Kt, Kr, Kr.abs().max())
            ea, na = _norm_err(A, Ar, Ar.abs().max())
            log("[kernels]   masked_system %s: Kt %.3e, A %.3e"
                % (kernel, ek, ea))
            errs.append((max(ek, ea), max(nk, na)))
        err, nerr = max(errs)
        _check("masked_system", dname, err, nerr)
        rec["masked_system"] = {"err": err}
        if dtype == torch.float32:
            rec["masked_system"]["ms"] = _time_ms(
                lambda: gk.masked_system(Xs, mask, vt, njt, kernel="RBF"))
            rec["masked_system"]["plain_ms"] = _time_ms(
                lambda: gk.masked_system_plain(Xs, mask, vt, njt,
                                               kernel="RBF"))
            rec["masked_system"]["library_ms"] = None
            rec["masked_system"]["bound"] = bound("masked_system", n,
                                                  Xs.shape[1])

        # K3 on an SPD Ainv built from the real masked RBF system
        Kt, A = gk.masked_system(Xs, mask, vt, njt, kernel="RBF")
        L, info = safe_cholesky(A)
        if int(info.item()) != 0:
            raise AssertionError("Cholesky of the K3 test system failed")
        V = tri_inverse(L)
        alpha = V.T @ (V @ (y * mask))
        Ainv = V.T @ V
        Xr = t(Xp).contiguous()
        got = gk.rbf_bwd_reductions(Ainv, Kt, alpha, mask, Xr)
        d64 = [x.double() for x in (Ainv, Kt, alpha, mask, Xr)]
        ref = gk.rbf_bwd_reductions_plain(*d64)
        absW = ((d64[0] - d64[2][:, None] * d64[2][None, :]).abs()
                * (d64[3][:, None] * d64[3][None, :]) * d64[1].abs())
        row_scale = absW.sum(dim=1).max()
        scales = (absW.sum(), row_scale, row_scale * d64[4].abs().max(),
                  (torch.diagonal(d64[0]) * d64[3] ** 2).abs().sum())
        errs = [_norm_err(g_, r_, s_) for g_, r_, s_ in zip(got, ref, scales)]
        err, nerr = max(e for e, _ in errs), max(ne for _, ne in errs)
        log("[kernels]   rbf_bwd_reductions S1/rw/WX/diagsum normalized: "
            + ", ".join("%.3e" % ne for _, ne in errs))
        _check("rbf_bwd_reductions", dname, err, nerr)
        rec["rbf_bwd_reductions"] = {"err": err}
        if dtype == torch.float32:
            rec["rbf_bwd_reductions"]["ms"] = _time_ms(
                lambda: gk.rbf_bwd_reductions(Ainv, Kt, alpha, mask, Xr))
            rec["rbf_bwd_reductions"]["plain_ms"] = _time_ms(
                lambda: gk.rbf_bwd_reductions_plain(Ainv, Kt, alpha, mask,
                                                    Xr))
            rec["rbf_bwd_reductions"]["library_ms"] = None
            rec["rbf_bwd_reductions"]["bound"] = bound(
                "rbf_bwd_reductions", n, Xr.shape[1])
        report[dname] = rec
        del Kt, A, L, V, Ainv, absW
        torch.cuda.empty_cache()
    def show(name, r):
        log("[kernels] %-19s float32 kernel %.4f ms%s, plain %.4f ms, "
            "library %s ms, bound %.4f ms (%s), %.0f%% of bound (%s of %d)"
            % (name, r["ms"], "" if "loop_ms" not in r else
               " (%.4f in a loop of calls)" % r["loop_ms"], r["plain_ms"],
               "none" if r["library_ms"] is None else
               "%.4f" % r["library_ms"], r["bound"][0], r["bound"][1],
               100 * r["bound"][0] / r["ms"],
               "graph" if "loop_ms" in r else "warm loop", TIMING_REPS))
    for name, r in report["float32"].items():
        show(name, r)
    for label, r in report["float32"]["sqdist"]["vfe_shapes"].items():
        show("sqdist VFE " + label, r)
    return report["float32"]


def _reset_launches():
    from gpim_tpu_torch.ops import gram_kernels as gk
    for fn in (gk.sqdist, gk.masked_system, gk.rbf_bwd_reductions):
        fn.launches = 0


def _read_launches():
    from gpim_tpu_torch.ops import gram_kernels as gk
    return {fn.__name__: fn.launches
            for fn in (gk.sqdist, gk.masked_system, gk.rbf_bwd_reductions)}


def _run_flagship(R, X, X_full, precision, label, **kwargs):
    import torch
    from gpim_tpu_torch import reconstructor
    # no use_gpu: the card is the default device
    model = reconstructor(X, R, X_full, kernel="RBF", iterations=ITERATIONS,
                          precision=precision, verbose=0, **kwargs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, sd, hp = model.run()
    total = time.perf_counter() - t0
    ph = model.timer.phases
    obs = ~np.isnan(R)
    rmse = float(np.sqrt(np.mean((mean[obs] - R[obs]) ** 2)))
    ls = hp["lengthscale"]
    drift = np.max(np.abs(ls[-1] - ls[-51]) / np.abs(ls[-1]))
    log("[flagship] %-11s train %.3f s, predict %.3f s, total %.3f s, "
        "rmse_obs %.5f, lengthscale %s (moved %.2e over the last 50 steps), "
        "noise %.6g, loss %.6g" % (
            label, ph["train"]["first_s"], ph["predict"]["first_s"], total,
            rmse, np.array2string(ls[-1], precision=4), drift,
            hp["noise"][-1], model.losses[-1]))
    return model, mean, sd, hp, rmse


def phase_flagship(R, X, X_full):
    import torch
    _reset_launches()
    _run_flagship(R, X, X_full, "single", "f32 cold")
    _reset_launches()
    model, mean, sd, hp, rmse = _run_flagship(R, X, X_full, "single",
                                              "f32 warm")
    launches = _read_launches()
    log("[flagship] kernel launches in the warm run: %s" % launches)
    if np.isnan(mean).any() or np.isnan(sd).any():
        raise AssertionError("flagship prediction has NaNs")
    if mean.shape != R.shape or sd.shape != R.shape:
        raise AssertionError("flagship prediction has the wrong shape")
    if not rmse < 0.1:
        raise AssertionError("flagship rmse_obs %.4f >= 0.1" % rmse)
    if not all(c > 0 for c in launches.values()):
        raise AssertionError("a kernel of the main path was never launched: "
                             "%s" % launches)
    tensors = (list(model.u.values()) + list(model._bounds().values())
               + [model._Xd, model._yd, model._maskd])
    if not all(t.is_cuda for t in tensors):
        raise AssertionError("a model built without use_gpu has a tensor "
                             "that is not on the card")
    log("[flagship] peak device memory %.1f MiB" % (
        torch.cuda.max_memory_allocated() / 2 ** 20))
    return launches, (mean, sd, hp)


def _run_vfe(vfe, precision, label, **kwargs):
    import torch
    from gpim_tpu_torch import reconstructor
    R, X, X_full, truth = vfe
    # no use_gpu: the card is the default device
    model = reconstructor(X, R, X_full, precision=precision, verbose=0,
                          **VFE, **kwargs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, sd, hp = model.run()
    total = time.perf_counter() - t0
    ph = model.timer.phases
    # benchmarks/suite.py:237-239
    tnorm = (truth - truth.min()) / np.ptp(truth)
    mnorm = (mean - truth.min()) / np.ptp(truth)
    rmse = float(np.sqrt(np.mean((mnorm - tnorm) ** 2)))
    log("[vfe] %-11s train %.3f s, predict %.3f s, total %.3f s, "
        "rmse_vs_truth %.5f, n = %d, m = %d, lengthscale %s, noise %.6g, "
        "loss %.6g" % (
            label, ph["train"]["first_s"], ph["predict"]["first_s"], total,
            rmse, model._Xd.shape[0], model.u["Xu"].shape[0],
            np.array2string(hp["lengthscale"][-1], precision=4),
            hp["noise"][-1], model.losses[-1]))
    return model, mean, sd, hp, rmse


def phase_vfe(vfe):
    import torch
    R = vfe[0]
    _reset_launches()
    _run_vfe(vfe, "single", "f32 cold")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    model, mean, sd, hp, rmse = _run_vfe(vfe, "single", "f32 warm")
    launches = _read_launches()
    n_chunks = -(-int(np.prod(R.shape)) // 4096)
    expected = 2 * VFE["iterations"] + 2 + n_chunks
    log("[vfe] kernel launches in the warm run: %s (K1 expected %d: Kmm and "
        "Kmn per step, both once more and %d chunks in predict)"
        % (launches, expected, n_chunks))
    log("[vfe] peak device memory %.1f MiB (warm run)" % (
        torch.cuda.max_memory_allocated() / 2 ** 20))
    if np.isnan(mean).any() or np.isnan(sd).any():
        raise AssertionError("VFE prediction has NaNs")
    if mean.shape != R.shape or sd.shape != R.shape:
        raise AssertionError("VFE prediction has the wrong shape")
    if not rmse < 0.1:
        raise AssertionError("VFE rmse_vs_truth %.4f >= 0.1" % rmse)
    if launches["sqdist"] == 0:
        raise AssertionError("K1 was never launched on the VFE path")
    tensors = (list(model.u.values()) + list(model._bounds().values())
               + [model._Xd, model._yd, model._maskd])
    if not all(t.is_cuda for t in tensors):
        raise AssertionError("a VFE model built without use_gpu has a "
                             "tensor that is not on the card")
    return launches, (mean, sd, hp, rmse, model.u, model.losses)


def phase_cross_check(R, X, X_full, f32, vfe, vfe32):
    import torch
    from gpim_tpu_torch import dtypes, reconstructor, utils
    # same objective in both precisions: the default jitter differs by
    # precision (1e-4 vs 1e-5) and on this noise-free scan the learned
    # noise falls below it, so the f64 run takes the f32 jitter
    _, m64, s64, h64, _ = _run_flagship(
        R, X, X_full, "double", "f64",
        jitter=dtypes.default_jitter(torch.float32))
    m32, s32, h32 = f32
    diffs = {
        "mean_atol": float(np.abs(m32 - m64).max()),
        "sd_atol": float(np.abs(s32 - s64).max()),
        "ls_rtol": float(np.max(np.abs(h32["lengthscale"][-1]
                                       - h64["lengthscale"][-1])
                                / np.abs(h64["lengthscale"][-1]))),
        "noise_atol": float(abs(h32["noise"][-1] - h64["noise"][-1])),
    }
    log("[cross-check] f32 vs f64 flagship: %s (limits %s)"
        % (json.dumps(diffs), json.dumps(CROSS_TOL)))
    for k, lim in CROSS_TOL.items():
        if not diffs[k] <= lim:
            raise AssertionError("f32 vs f64 %s %.3e > %.0e"
                                 % (k, diffs[k], lim))

    # small problem through every kernel in float64: CUDA vs the CPU path
    Rs = small_data()
    Xs, Xfs = utils.get_sparse_grid(Rs), utils.get_full_grid(Rs)
    out = {}
    for use_gpu in (True, False):
        for kernel in ("RBF", "Matern52", "RationalQuadratic"):
            mean, sd, hp = reconstructor(
                Xs, Rs, Xfs, kernel=kernel, iterations=30,
                learning_rate=0.1, precision="double", use_gpu=use_gpu,
                verbose=0).run()
            out[use_gpu, kernel] = (mean, sd, hp["lengthscale"])
    for kernel in ("RBF", "Matern52", "RationalQuadratic"):
        worst = max(float(np.max(np.abs(g - c)) / np.max(np.abs(c)))
                    for g, c in zip(out[True, kernel], out[False, kernel]))
        log("[cross-check] small 24x24 %s, CUDA vs CPU (f64): max diff / "
            "max value %.3e (limit %.0e)" % (kernel, worst, SMALL_RTOL))
        if not worst <= SMALL_RTOL:
            raise AssertionError("CUDA and CPU paths disagree on %s" % kernel)

    # the VFE run in float64 at the float32 jitter
    model64, m64, s64, h64, r64 = _run_vfe(
        vfe, "double", "f64", jitter=dtypes.default_jitter(torch.float32))
    m32, s32, h32, r32, u32, losses32 = vfe32
    model64.u = {k: v.double() for k, v in u32.items()}
    m64u, s64u = model64.predict()
    vdiffs = {
        "mean_atol": float(np.abs(m32 - m64).max()),
        "sd_atol": float(np.abs(s32 - s64).max()),
        "ls_rtol": float(np.max(np.abs(h32["lengthscale"][-1]
                                       - h64["lengthscale"][-1])
                                / np.abs(h64["lengthscale"][-1]))),
        "noise_rtol": float(abs(h32["noise"][-1] - h64["noise"][-1])
                            / abs(h64["noise"][-1])),
        "rmse_diff": abs(r32 - r64),
        "loss0_rtol": float(abs(losses32[0] - model64.losses[0])
                            / abs(model64.losses[0])),
        "same_u_mean_atol": float(np.abs(m32 - m64u).max()),
        "same_u_sd_atol": float(np.abs(s32 - s64u).max()),
    }
    log("[cross-check] f32 vs f64 VFE: %s (limits %s); inducing points "
        "%.3e apart at most" % (
            json.dumps(vdiffs), json.dumps(VFE_CROSS_TOL),
            float(np.abs(h32["inducing_points"][-1]
                         - h64["inducing_points"][-1]).max())))
    for k, lim in VFE_CROSS_TOL.items():
        if not vdiffs[k] <= lim:
            raise AssertionError("f32 vs f64 VFE %s %.3e > %.0e"
                                 % (k, vdiffs[k], lim))

    # small sparse problem in float64: CUDA vs the CPU path
    out = {}
    for use_gpu in (True, False):
        for kernel in ("RBF", "Matern52", "RationalQuadratic"):
            mean, sd, hp = reconstructor(
                Xs, Rs, Xfs, kernel=kernel, sparse=True, indpoints=40,
                iterations=30, learning_rate=0.1, precision="double",
                use_gpu=use_gpu, verbose=0).run()
            out[use_gpu, kernel] = (mean, sd, hp["lengthscale"],
                                    hp["inducing_points"])
    for kernel in ("RBF", "Matern52", "RationalQuadratic"):
        worst = max(float(np.max(np.abs(g - c)) / np.max(np.abs(c)))
                    for g, c in zip(out[True, kernel], out[False, kernel]))
        log("[cross-check] small 24x24 sparse %s, CUDA vs CPU (f64): max "
            "diff / max value %.3e (limit %.0e)" % (kernel, worst,
                                                   SMALL_RTOL))
        if not worst <= SMALL_RTOL:
            raise AssertionError("CUDA and CPU sparse paths disagree on %s"
                                 % kernel)
    return diffs, vdiffs


def phase_profile(label, R, X, X_full, **kwargs):
    """Device time per warm training step, by kernel name, and the share of
    the host's train() window in which the device ran no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gpim_tpu_torch import reconstructor
    model = reconstructor(X, R, X_full, precision="single", verbose=0,
                          **kwargs)
    model.iterations = PROFILE_STEPS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name] = (per_name.get(e.name, 0.0)
                                + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(per_name.values())
    if busy_ms == 0.0:
        log("[profile] the profiler recorded no device time: not measured")
        return
    log("[profile] %s: %d warm f32 training steps: %.3f ms a step on the "
        "host clock, %.3f ms of device time, device idle %.1f%%"
        % (label, PROFILE_STEPS, wall_ms / PROFILE_STEPS,
           busy_ms / PROFILE_STEPS,
           100.0 * max(0.0, 1.0 - busy_ms / wall_ms)))
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1])
    ours = ("sqdist_kernel", "masked_system_kernel", "rbf_bwd_kernel")
    for i, (name, ms) in enumerate(ranked):
        if i < 10 or any(k in name for k in ours):
            log("[profile] %8.4f ms/step %5.1f%%  %s" % (
                ms / PROFILE_STEPS, 100.0 * ms / busy_ms, name[:100]))


def kernel_records(kreport, paths):
    """The kernels line; ``paths`` maps each main path to its warm run's
    launch counts, and ``launches`` is their sum."""
    replaces = {"sqdist": "gpim_tpu/ops/pallas_gram.py:77",
                "masked_system": "gpim_tpu/ops/pallas_gram.py:186",
                "rbf_bwd_reductions": "gpim_tpu/ops/pallas_gram.py:283"}
    out = []
    for name in ("sqdist", "masked_system", "rbf_bwd_reductions"):
        r = kreport[name]
        bound_ms, bound_by = r["bound"]
        out.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces[name],
            "launches": sum(p[name] for p in paths.values()),
            "launches_per_path": {k: p[name] for k, p in paths.items()},
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / r["ms"],
            "library_ms": r["library_ms"],
            "library": ("torch.cdist, the nearest call: it returns the root "
                        "of this kernel's output" if name == "sqdist"
                        else None),
        })
        if name == "sqdist":
            out[-1]["vfe_shapes"] = {
                label: {"shape": v["shape"], "max_abs_err": v["err"],
                        "ms": v["ms"], "plain_ms": v["plain_ms"],
                        "bound_ms": v["bound"][0], "bound_by": v["bound"][1],
                        "bound_share": v["bound"][0] / v["ms"],
                        "library_ms": v["library_ms"]}
                for label, v in r["vfe_shapes"].items()}
    return out


def main():
    import torch
    phase_device()
    phase_build()
    R, X, X_full = flagship_data()
    vfe = vfe_data()
    kreport = phase_kernels(R, X, X_full, vfe)
    launches, f32 = phase_flagship(R, X, X_full)
    vfe_launches, vfe32 = phase_vfe(vfe)
    phase_cross_check(R, X, X_full, f32, vfe, vfe32)
    phase_profile("flagship", R, X, X_full, kernel="RBF")
    phase_profile("vfe", *vfe[:3], **VFE)
    print(json.dumps({"kernels": kernel_records(
        kreport, {"flagship": launches, "vfe": vfe_launches})}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
