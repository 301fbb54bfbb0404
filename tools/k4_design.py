#!/usr/bin/env python3
"""
Design measurements of kernel K4 (``interp_adjoint``, the off-lattice
interpolation adjoint W^T v) on one CUDA card.

    python3 tools/k4_design.py compare TREE [TREE ...]

It takes K4's operands at the two off-lattice rows of ``chip_smoke.py``
(ski_offlattice64x64x32: 39,424 padded points on 36^3 cells;
ski_offlattice128x128x64: 314,624 on 70^3), built as its SKI engine builds
them (the 128-row padding, ``choose_grid``, ``build_interp``, the stable
sort by lower corner), at the block widths the off-lattice paths give it
(b = 1, 9, 100), with v drawn from a seeded generator.

``compare`` runs each tree given (a checkout's root, each in its own
process, in the order given) on the same operands: its own
``interp_layout`` and ``interp_adjoint``, float32 timed by three CUDA
graphs of 50 calls and by three warm loops of 50 calls (CUDA events; the
helpers of ``chip_smoke.py``),
float32 and float64 outputs written to
``build/k4_design/out_<i>.npz``; for a tree with K4's two kernels, also
both at b = 1 to 100 on the same layout (the crossover the wrapper's
``_RUNS_MIN_OUTPUTS`` sets). It then holds every tree's outputs bit for
bit against the first tree's and against the plain version run on the CPU
(``interp_adjoint_plain`` of the tree running this script; float64 at 1M
and b = 100 is left out, 2 GB of rows). Unpack a parent commit with ``git
archive`` into a gitignored directory and give it twice, around this tree
(parent, change, change, parent), to compare the two on one card. The
record goes to ``build/k4_design/report.json``.
"""

import json
import os
import subprocess
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORK = os.path.join(_ROOT, "build", "k4_design")
PEAK_BYTES_PER_S = 3.35e12
WIDTHS = (1, 9, 100)
CROSS_WIDTHS = (1, 2, 4, 9, 16, 32, 100)
ROWS = ("ski_offlattice64x64x32", "ski_offlattice128x128x64")


def _card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def make_inputs(path):
    """Each row's sorted corner indices and weights, float32 and float64,
    saved to ``path``."""
    sys.path.insert(0, _ROOT)
    import chip_smoke
    from gpim_tpu_torch import utils
    from gpim_tpu_torch.gpreg import engine
    from gpim_tpu_torch.ops import ski
    arrays = {}
    for row in ROWS:
        R = (chip_smoke.ski_masked_data()[0]
             if row == "ski_offlattice64x64x32"
             else chip_smoke.mgrid_data(chip_smoke.OFFLATTICE_ROWS[row][0])
             [0])
        for name, dt, prec in (("f32", np.float32, "single"),
                               ("f64", np.float64, "double")):
            X_np, _ = utils.prepare_training_data(
                utils.get_sparse_grid(R), R, precision=prec)
            Xp, n = engine.pad_rows(X_np, 128)
            mask = np.zeros(len(Xp), dt)
            mask[:n] = 1.0
            grids = [np.asarray(g, dt) for g in ski.choose_grid(X_np)]
            idx, wgt = ski.build_interp(np.asarray(Xp, dt), grids, mask)
            perm = np.argsort(idx[:, 0], kind="stable")
            arrays["%s/%s/idx" % (row, name)] = idx[perm].astype(np.int64)
            arrays["%s/%s/wgt" % (row, name)] = wgt[perm]
            arrays["%s/G" % row] = np.int64(np.prod([len(g) for g in grids]))
    np.savez(path, **arrays)


def _block(b, n, dtype):
    import torch
    g = torch.Generator().manual_seed(1000 * b + n % 1000)
    return torch.randn(b, n, generator=g, dtype=torch.float64).to(dtype)


def _layouts(inputs, name, dtype, gk):
    """(row, layout on the card) of each row, by ``gk.interp_layout``."""
    import torch
    for row in ROWS:
        yield row, gk.interp_layout(
            torch.as_tensor(inputs["%s/%s/idx" % (row, name)],
                            device="cuda"),
            torch.as_tensor(inputs["%s/%s/wgt" % (row, name)],
                            device="cuda"), int(inputs["%s/G" % row]))


def _crossover(gk, lay):
    """Graph ms of both K4 kernels of a tree that has two (the runs kernel
    forced at any size, the CSR kernel on the same layout without its
    runs) at CROSS_WIDTHS, and whether the two agree bit for bit."""
    csr = lay._replace(lcptr=None, wrun=None, offsets=None)
    threshold = gk._RUNS_MIN_OUTPUTS
    out = {}
    try:
        gk._RUNS_MIN_OUTPUTS = 0
        for b in CROSS_WIDTHS:
            v = _block(b, lay.n, lay.wgt.dtype).cuda()
            out["b%d" % b] = {
                "runs_ms": min(_graph_ms(lambda: gk.interp_adjoint(lay, v))),
                "csr_ms": min(_graph_ms(lambda: gk.interp_adjoint(csr, v))),
                "equal": bool((gk.interp_adjoint(lay, v)
                               == gk.interp_adjoint(csr, v)).all())}
    finally:
        gk._RUNS_MIN_OUTPUTS = threshold
    return out


def _graph_ms(fn):
    """Three replays of a CUDA graph of 50 calls (chip_smoke.py's)."""
    import chip_smoke
    return [chip_smoke._time_graph_ms(fn) for _ in range(3)]


def _loop_ms(fn):
    """Three warm loops of 50 calls (chip_smoke.py's)."""
    import chip_smoke
    return [chip_smoke._time_ms(fn) for _ in range(3)]


def time_tree(root, inputs_path, out_path):
    """Times and outputs of the tree at ``root``; prints one JSON line."""
    import torch
    sys.path[:0] = [root, _ROOT]
    from gpim_tpu_torch.ops import _build
    from gpim_tpu_torch.ops import gram_kernels as gk
    if not os.path.realpath(gk.__file__).startswith(os.path.realpath(root)):
        raise RuntimeError("imported %s, not the tree's" % gk.__file__)
    _build.build()
    inputs = np.load(inputs_path)
    rec, outs = {}, {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        for row, lay in _layouts(inputs, name, dtype, gk):
            for b in WIDTHS:
                v = _block(b, lay.n, dtype).cuda()
                outs["%s/%s/b%d" % (row, name, b)] = \
                    gk.interp_adjoint(lay, v).cpu().numpy()
                if name == "f32":
                    rec["%s/b%d" % (row, b)] = {
                        "graph_ms": _graph_ms(
                            lambda: gk.interp_adjoint(lay, v)),
                        "loop_ms": _loop_ms(
                            lambda: gk.interp_adjoint(lay, v))}
                del v
            if name == "f32" and getattr(lay, "wrun", None) is not None:
                rec["%s/crossover" % row] = _crossover(gk, lay)
            del lay
            torch.cuda.empty_cache()
    np.savez(out_path, **outs)
    print(json.dumps({"tree": root, "times": rec}), flush=True)


def compare(trees):
    import torch
    sys.path.insert(0, _ROOT)
    from gpim_tpu_torch.ops import gram_kernels as gk
    os.makedirs(_WORK, exist_ok=True)
    card = _card()
    print(card, flush=True)
    inputs_path = os.path.join(_WORK, "inputs.npz")
    make_inputs(inputs_path)
    inputs = np.load(inputs_path)
    records = []
    for i, tree in enumerate(trees):
        out_path = os.path.join(_WORK, "out_%d.npz" % i)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "_tree",
             os.path.abspath(tree), inputs_path, out_path],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError("tree %s failed:\n%s" % (tree, proc.stderr))
        records.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        records[-1]["outputs"] = out_path
    first = np.load(records[0]["outputs"])
    report = {"card": card, "trees": [], "bounds_ms": {}}
    plain = {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        for row in ROWS:
            idx = torch.as_tensor(inputs["%s/%s/idx" % (row, name)])
            lay = gk.interp_layout(
                idx, torch.as_tensor(inputs["%s/%s/wgt" % (row, name)]),
                int(inputs["%s/G" % row]))
            n, S = idx.shape
            for b in WIDTHS:
                key = "%s/%s/b%d" % (row, name, b)
                if name == "f32":
                    read, written, _ = gk.min_traffic(
                        "interp_adjoint", n, S.bit_length() - 1, m=lay.G,
                        itemsize=4, batch=b)
                    report["bounds_ms"]["%s/b%d" % (row, b)] = \
                        (read + written) / PEAK_BYTES_PER_S * 1e3
                if name == "f64" and b == 100 and n > 100000:
                    continue
                plain[key] = gk.interp_adjoint_plain(
                    lay, _block(b, n, dtype)).numpy()
    for rec in records:
        outs = np.load(rec["outputs"])
        rec["equal_to_first"] = all(np.array_equal(outs[k], first[k])
                                    for k in first.files)
        rec["equal_to_cpu_plain"] = {k: bool(np.array_equal(outs[k], p))
                                     for k, p in plain.items()}
        report["trees"].append(rec)
        print("== %s: bit-equal to the first tree %s, to the CPU plain "
              "version %s" % (rec["tree"], rec["equal_to_first"],
                              all(rec["equal_to_cpu_plain"].values())))
        for key, t in rec["times"].items():
            if key.endswith("crossover"):
                for width, c in t.items():
                    print("  %-36s runs kernel %.4f ms, CSR kernel %.4f ms, "
                          "equal %s" % (key[:-9] + width, c["runs_ms"],
                                        c["csr_ms"], c["equal"]))
                continue
            bound = report["bounds_ms"][key]
            print("  %-36s graph %s ms, loop %s ms; bound %.4f ms, %.0f%%"
                  % (key, " ".join("%.4f" % x for x in t["graph_ms"]),
                     " ".join("%.4f" % x for x in t["loop_ms"]), bound,
                     100 * bound / min(t["graph_ms"])), flush=True)
    with open(os.path.join(_WORK, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    if not all(r["equal_to_first"] and all(r["equal_to_cpu_plain"].values())
               and all(c["equal"] for k, t in r["times"].items()
                       if k.endswith("crossover") for c in t.values())
               for r in report["trees"]):
        sys.exit("K4 outputs differ between trees or from the CPU plain "
                 "version")


def main(argv):
    if argv[:1] == ["compare"] and len(argv) > 1:
        compare(argv[1:])
    elif argv[:1] == ["_tree"] and len(argv) == 4:
        time_tree(*argv[1:])
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
