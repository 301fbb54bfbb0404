#!/usr/bin/env python3
"""
Design measurements of the explicit inverse ``A^-1 = V^T V``, ``V = L^-1``
(``gpim_tpu_torch/ops/tri.py``: ``tri_inverse`` and ``tri_gram``) on one
CUDA card.

    python3 tools/tri_design.py [--quick]

For float64 and float32, at the orders the port's callers give these
functions (n = 128, BO's padded set; 896, quickstart's image; 1027, the
VFE's inducing points; 2048 with a task axis of 64, eels64; 640 with a
task axis of 6, eels6; 2048 to 6144, the spiral's padded 6,036 among
them) and at batches around the crossover, it times by CUDA events around
warm loops (the median of three):

- the library route: ``solve_triangular(L, I)``, ``V.mT @ V``, both;
- the blocked route at each leaf size ``_LEAF`` that splits the order
  (128, 256, 512, 1024): the inverse alone, the Gram alone, both;

and reads each route's largest relative gap to the library route, and at
6144 its peak memory and the host's time to enqueue it. It times K3 (``rbf_bwd_reductions``) at 6144 right
after each route's A^-1, with and without the L2 cache overwritten in
between, and then profiles, at 6144 in float64, the Cholesky
(``cholesky_ex``), the library inverse and the library product one at a
time, and the blocked pair, so that every device kernel of the exact GP's
training step is attributed to the call that launches it, and prints the
crossover: per dtype, the least size measured (the elements of the whole
batch, given as the order of one matrix that size) from which the blocked
route beats the library one at every larger size. ``--quick``
keeps 2048 and 6144 and one leaf size. The record goes to
``build/tri_design/report.json`` (copy it under ``chiprun_out/`` to bring
it back).
"""

import json
import os
import statistics
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORK = os.path.join(_ROOT, "build", "tri_design")
# (label, task axis, n): the callers' orders, then batches around the
# crossover's size (a task axis of T at order n has the elements of one
# matrix of order n sqrt(T))
SHAPES = (("bo", None, 128), ("quickstart", None, 896), ("vfe_m", None, 1027),
          ("eels64", 64, 2048), ("n2048", None, 2048), ("n3072", None, 3072),
          ("n4096", None, 4096), ("n6016", None, 6016), ("spiral", None, 6144),
          ("eels6", 6, 640), ("t2x2048", 2, 2048), ("t3x2048", 3, 2048),
          ("t4x2048", 4, 2048),
          ("t8x2048", 8, 2048), ("t16x1024", 16, 1024), ("t64x512", 64, 512))
LEAVES = (128, 256, 512, 1024)


def _card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def _factor(task, n, dtype):
    """The Cholesky factor of ``I + W W^T / n`` (eigenvalues in [1, 5]),
    ``W`` seeded, on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(n)
    shape = (n, n) if task is None else (task, n, n)
    W = torch.randn(shape, generator=g, device="cuda", dtype=torch.float64)
    A = W @ W.mT / n + torch.eye(n, device="cuda", dtype=torch.float64)
    return torch.linalg.cholesky_ex(A.to(dtype)).L


def _ms(fn, reps):
    """Median of three warm loops of ``reps`` calls, ms a call."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def _host_ms(fn, reps):
    """Host ms a call to enqueue ``reps`` calls (the card still busy with
    them), after a warm call: the dispatch the host adds to a step."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / reps * 1e3


def _gap(x, ref):
    return ((x.double() - ref.double()).abs().max()
            / ref.double().abs().max()).item()


def _peak_bytes(fn):
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _device_us(event):
    return getattr(event, "device_time_total",
                   getattr(event, "cuda_time_total", 0))


def measure(shapes, leaves):
    """Times, gaps and peaks of both routes at ``shapes``."""
    import torch
    from gpim_tpu_torch.ops import tri
    out = {}
    for dname, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        for label, task, n in shapes:
            L = _factor(task, n, dtype)
            reps = 50 if n < 2048 else 10
            inv = lambda: torch.linalg.solve_triangular(  # noqa: E731
                L, torch.eye(n, dtype=dtype, device="cuda"), upper=False)
            V = inv()
            G = V.mT @ V
            both = lambda: (lambda v: v.mT @ v)(inv())  # noqa: E731
            rec = {"library": {"inverse_ms": _ms(inv, reps),
                               "gram_ms": _ms(lambda: V.mT @ V, reps),
                               "both_ms": _ms(both, reps)}}
            if n == 6144:
                rec["library"]["peak_bytes"] = _peak_bytes(both)
                rec["library"]["host_ms"] = _host_ms(both, reps)
            for leaf in leaves:
                if n < 2 * leaf:
                    continue
                tri._LEAF = leaf
                Vb = tri._tri_inverse_blocked(L)
                Gb = tri._tri_gram_blocked(V)
                r = {"inverse_ms": _ms(lambda: tri._tri_inverse_blocked(L),
                                       reps),
                     "gram_ms": _ms(lambda: tri._tri_gram_blocked(V), reps),
                     "both_ms": _ms(lambda: tri._tri_gram_blocked(
                         tri._tri_inverse_blocked(L)), reps),
                     "inverse_gap": _gap(Vb, V), "gram_gap": _gap(Gb, G),
                     "upper_zero": bool((Vb.triu(1) == 0).all()),
                     "symmetric": bool(torch.equal(Gb, Gb.mT)),
                     "leaves": tri._tree(n)[1][:2],
                     "nodes": len(tri._tree(n)[0])}
                if n == 6144:
                    r["peak_bytes"] = _peak_bytes(
                        lambda: tri._tri_gram_blocked(
                            tri._tri_inverse_blocked(L)))
                    r["host_ms"] = _host_ms(lambda: tri._tri_gram_blocked(
                        tri._tri_inverse_blocked(L)), reps)
                rec["leaf%d" % leaf] = r
                del Vb, Gb
            key = "%s/%s" % (dname, label)
            out[key] = rec
            lib = rec["library"]
            print("%-16s library inv %.4f gram %.4f both %.4f ms" % (
                key, lib["inverse_ms"], lib["gram_ms"], lib["both_ms"]),
                flush=True)
            for k, r in rec.items():
                if "host_ms" in r:
                    print("%-16s %-8s peak %.3f GiB, host %.3f ms a call" % (
                        "", k, r["peak_bytes"] / 2 ** 30, r["host_ms"]))
                if k == "library":
                    continue
                print("%-16s %-8s inv %.4f gram %.4f both %.4f ms; gaps "
                      "%.2e %.2e; upper 0 %s, symmetric %s; leaves %s" % (
                          "", k, r["inverse_ms"], r["gram_ms"],
                          r["both_ms"], r["inverse_gap"], r["gram_gap"],
                          r["upper_zero"], r["symmetric"], r["leaves"]),
                      flush=True)
            del L, V, G
            torch.cuda.empty_cache()
    return out


def attribute():
    """Device kernels, ms a call, of the Cholesky, the library inverse,
    the library product and the blocked pair at 6144 in float64."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gpim_tpu_torch.ops import tri
    n = 6144
    L = _factor(None, n, torch.float64)
    A = L @ L.mT
    V = torch.linalg.solve_triangular(
        L, torch.eye(n, dtype=L.dtype, device="cuda"), upper=False)
    calls = {
        "cholesky_ex": lambda: torch.linalg.cholesky_ex(A),
        "solve_triangular(L, I)": lambda: torch.linalg.solve_triangular(
            L, torch.eye(n, dtype=L.dtype, device="cuda"), upper=False),
        "V.mT @ V": lambda: V.mT @ V,
        "blocked tri_inverse": lambda: tri._tri_inverse_blocked(L),
        "blocked tri_gram": lambda: tri._tri_gram_blocked(V)}
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        reps = 5
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = sorted(((e.key, _device_us(e) / 1e3 / reps, e.count)
                       for e in prof.key_averages() if _device_us(e) > 0),
                      key=lambda r: -r[1])
        out[name] = rows[:8]
        print("== %s (ms a call, launches in %d calls)" % (name, reps))
        for key, ms, count in rows[:8]:
            print("   %8.4f %5d  %s" % (ms, count, key[:110]))
    return out


def crossover(rec, leaf):
    """Per dtype, the least size (elements of the whole batch) from which
    the blocked pair at ``leaf`` beats the library pair at every size
    measured as large or larger, as the order of one matrix of that size."""
    out = {}
    for dname in ("f64", "f32"):
        wins = {}
        for label, task, n in SHAPES:
            r = rec.get("%s/%s" % (dname, label))
            if r is not None:
                b = r.get("leaf%d" % leaf)
                wins.setdefault((task or 1) * n * n, []).append(
                    b is not None
                    and b["both_ms"] < r["library"]["both_ms"])
        best = None
        for size in sorted(wins, reverse=True):
            if not all(wins[size]):
                break
            best = round(size ** 0.5)
        out[dname] = best
    return out


def k3_after():
    """K3's device ms at the spiral's order (n = 6144, float64, d = 2) when
    A^-1 comes from each route just before it, as in the training step,
    and with the L2 cache overwritten in between: the median of 20 calls,
    CUDA events around K3 alone."""
    import torch
    from gpim_tpu_torch.ops import gram_kernels as gk
    from gpim_tpu_torch.ops import tri
    n = 6144
    g = torch.Generator(device="cuda").manual_seed(7)
    X = torch.rand((n, 2), generator=g, device="cuda",
                   dtype=torch.float64) * 40.0
    Kt = torch.exp(-0.5 * torch.cdist(X, X) ** 2 / 9.0)
    A = Kt + 1e-2 * torch.eye(n, dtype=Kt.dtype, device="cuda")
    V = tri._tri_inverse_blocked(torch.linalg.cholesky_ex(A).L)
    alpha = torch.rand(n, generator=g, device="cuda", dtype=torch.float64)
    mask = torch.ones(n, dtype=torch.float64, device="cuda")
    flush = torch.empty(2 ** 27, dtype=torch.uint8, device="cuda")
    out = {}
    for name, make in (("library", lambda: V.mT @ V),
                       ("blocked", lambda: tri._tri_gram_blocked(V))):
        for flushed in (False, True):
            times = []
            for _ in range(21):
                Ainv = make()
                if flushed:
                    flush.fill_(1)
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                gk.rbf_bwd_reductions(Ainv, Kt, alpha, mask, X)
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b))
            key = name + (", L2 overwritten" if flushed else "")
            out[key] = statistics.median(times[1:])
            print("K3 after %-28s %.4f ms" % (key, out[key]), flush=True)
    return out


def main(argv):
    import torch
    sys.path.insert(0, _ROOT)
    if argv not in ([], ["--quick"]):
        sys.exit(__doc__)
    quick = argv == ["--quick"]
    card = _card()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    shapes = [s for s in SHAPES if not quick or s[2] in (2048, 6144)]
    leaves = (512,) if quick else LEAVES
    from gpim_tpu_torch.ops import tri
    leaf0 = tri._LEAF
    try:
        rec = measure(shapes, leaves)
    finally:
        tri._LEAF = leaf0
    report = {"card": card, "torch": torch.__version__, "times": rec,
              "kernels": attribute(), "k3_after": k3_after(),
              "crossover": {"leaf%d" % leaf: crossover(rec, leaf)
                            for leaf in leaves}}
    print("crossover (least order from which blocked wins):",
          json.dumps(report["crossover"]), "; module: _BLOCKED_MIN %d, "
          "_LEAF %d" % (tri._BLOCKED_MIN, tri._LEAF), flush=True)
    os.makedirs(_WORK, exist_ok=True)
    with open(os.path.join(_WORK, "report.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
