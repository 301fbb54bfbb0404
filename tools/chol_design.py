#!/usr/bin/env python3
"""
Design measurements of K5, ``gram_kernels.chol_inverse`` (the Cholesky
factor of an SPD matrix of order <= 128 and its inverse, one block a
matrix), against the library pair it replaces, ``cholesky_ex`` then
``solve_triangular(L, I)``, on one CUDA card.

    python3 tools/chol_design.py [--quick]

1. build: the kernel library, with ptxas' report of K5's registers,
   shared memory and spills when it is built here;
2. check: in float64 and float32, at n = 1, 2, 35, 127 and 128, unbatched
   and with a task axis of 8, K5's L and V against the library pair's
   (largest gap over the largest entry; K5's own plain version too), L and
   V zero above the diagonal, and ``info`` against cholesky_ex's on
   matrices whose leading minor of order 1, 36 or 128 is not positive
   definite; a profiler window holds one device operation a call;
3. time: at n = 128, task axes of 1, 8 and 64, in both precisions, K5 and
   the library pair each by one replay of a CUDA graph of 50 calls (ms a
   call), beside K5's bound, its plain version's time (a warm loop, one
   task) and its share of the bound. The bound is one SM a matrix at the
   SM's share of the card's vector peak (34 TFLOP/s float64, 67 float32,
   over 132 SMs) for 2 n^3 / 3 operations, or the bytes at 3.35 TB/s if
   larger: the kernel gives each matrix one block.

``--quick`` times one task only. The record goes to
``build/chol_design/report.json`` and, as its last line, to stdout.
"""

import json
import os
import statistics
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
_WORK = os.path.join(_ROOT, "build", "chol_design")
SMS = 132
PEAK = {"f64": 34e12, "f32": 67e12}
BYTES_PER_S = 3.35e12
GRAPH_CALLS = 50


def _card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def _spd(task, n, dtype, seed=0):
    """``I + W W^T / n`` (eigenvalues in [1, 5]), ``W`` seeded, on the
    card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(1000 * n + seed)
    shape = (n, n) if task is None else (task, n, n)
    W = torch.randn(shape, generator=g, device="cuda", dtype=torch.float64)
    A = W @ W.mT / n + torch.eye(n, device="cuda", dtype=torch.float64)
    return A.to(dtype).contiguous()


def _library(A):
    import torch
    L, info = torch.linalg.cholesky_ex(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return L, torch.linalg.solve_triangular(L, eye, upper=False), info


def _gap(x, ref):
    return ((x.double() - ref.double()).abs().max()
            / ref.double().abs().max()).item()


def bound_ms(n, task, dname):
    """K5's least time for ``task`` matrices of order ``n``: one SM a
    matrix (module docstring)."""
    itemsize = 8 if dname == "f64" else 4
    t = task or 1
    ops = 2.0 * n ** 3 / 3
    waves = -(-t // SMS)
    t_ops = waves * ops / (PEAK[dname] / SMS)
    t_bytes = t * (n * (n + 1) / 2 + 2 * n * n) * itemsize / BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3


def _graph_ms(fn):
    """One replay of a CUDA graph of ``GRAPH_CALLS`` calls, ms a call."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / GRAPH_CALLS)
    del graph
    return statistics.median(out)


def _loop_ms(fn, reps=5):
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def build():
    from gpim_tpu_torch.ops import _build
    res = _build.build()
    # ptxas names each function, then gives its frame, spills, registers
    log = res.log.splitlines()
    report = []
    for i, ln in enumerate(log):
        if "chol_inverse_kernel" in ln:
            report.extend(x.strip() for x in log[i:i + 4]
                          if x.strip() not in report)
    for ln in report:
        print("[build] " + ln, flush=True)
    return {"seconds": res.seconds, "ptxas": report}


def check():
    import torch
    from gpim_tpu_torch.ops import gram_kernels as gk
    tol = {"f64": 1e-13, "f32": 1e-5}
    out = {}
    for dname, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        for n in (1, 2, 35, 127, 128):
            for task in (None, 8):
                A = _spd(task, n, dtype)
                L, V, info = gk.chol_inverse(A)
                Lr, Vr, ir = _library(A)
                Lp, Vp, _ = gk.chol_inverse(A.cpu())
                rec = {"L_gap": _gap(L, Lr), "V_gap": _gap(V, Vr),
                       "plain_L_gap": _gap(L.cpu(), Lp),
                       "plain_V_gap": _gap(V.cpu(), Vp),
                       "info": int(info.abs().sum()),
                       "upper_zero": bool(
                           (L.triu(1) == 0).all() and (V.triu(1) == 0).all())}
                key = "%s n%d%s" % (dname, n, "" if task is None
                                    else " x%d" % task)
                out[key] = rec
                ok = (rec["L_gap"] <= tol[dname] and rec["V_gap"] <= tol[dname]
                      and rec["info"] == 0 and rec["upper_zero"])
                print("[check] %-14s L %.2e  V %.2e  plain L %.2e V %.2e  %s"
                      % (key, rec["L_gap"], rec["V_gap"], rec["plain_L_gap"],
                         rec["plain_V_gap"], "ok" if ok else "FAIL"),
                      flush=True)
                if not ok:
                    raise AssertionError("K5 %s: %s" % (key, rec))
        for k in (1, 36, 128):
            A = _spd(2, 128, dtype)
            A[1, k - 1, k - 1] = -5.0
            info = gk.chol_inverse(A)[2].tolist()
            ref = torch.linalg.cholesky_ex(A)[1].tolist()
            out["%s info k%d" % (dname, k)] = info
            print("[check] %s info, minor %d not PD: K5 %s, cholesky_ex %s"
                  % (dname, k, info, ref), flush=True)
            if info != ref:
                raise AssertionError("K5 info %s != %s" % (info, ref))
    from torch.profiler import ProfilerActivity, profile
    A = _spd(None, 128, torch.float64)
    gk.chol_inverse(A)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            gk.chol_inverse(A)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if getattr(e, "device_type", None) is not None
             and str(e.device_type).endswith("CUDA")]
    kernels = [nm for nm in names if "chol_inverse_kernel" in nm]
    print("[check] profiler: %d device operations for 5 calls, %d of them "
          "K5 (%s)" % (len(names), len(kernels), sorted(set(names))),
          flush=True)
    out["profiler_ops_5_calls"] = len(names)
    return out


def time_all(quick):
    import torch
    from gpim_tpu_torch.ops import gram_kernels as gk
    out = {}
    for dname, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        for task in ((None,) if quick else (None, 8, 64)):
            A = _spd(task, 128, dtype)
            rec = {"k5_ms": _graph_ms(lambda: gk.chol_inverse(A)),
                   "bound_ms": bound_ms(128, task, dname)}
            try:
                rec["library_ms"] = _graph_ms(lambda: _library(A))
            except RuntimeError as e:      # a library call refused capture
                print("[time] library pair not capturable (%s); timed by a "
                      "warm loop" % e, flush=True)
                rec["library_ms"] = _loop_ms(lambda: _library(A), 50)
                rec["library_timed_by"] = "warm loop"
            if task is None:
                rec["plain_ms"] = _loop_ms(lambda: gk.chol_inverse_plain(A))
            rec["share"] = rec["bound_ms"] / rec["k5_ms"]
            key = "%s x%d" % (dname, task or 1)
            out[key] = rec
            print("[time] n = 128 %-7s K5 %.4f ms, library pair %.4f ms "
                  "(%.1fx), bound %.4f ms (%.0f%%)%s"
                  % (key, rec["k5_ms"], rec["library_ms"],
                     rec["library_ms"] / rec["k5_ms"], rec["bound_ms"],
                     100 * rec["share"],
                     "" if "plain_ms" not in rec else
                     ", plain %.3f ms" % rec["plain_ms"]), flush=True)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chol_design.py needs a CUDA card")
    quick = "--quick" in sys.argv[1:]
    card = _card()
    print("[device] %s; torch %s, CUDA %s" % (card, torch.__version__,
                                             torch.version.cuda), flush=True)
    report = {"card": card, "build": build(), "check": check(),
              "time": time_all(quick)}
    os.makedirs(_WORK, exist_ok=True)
    with open(os.path.join(_WORK, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
