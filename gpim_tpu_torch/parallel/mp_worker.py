"""
One rank of a multi-process world (see
:func:`gpim_tpu_torch.parallel.distributed.dryrun_multiprocess` and
:func:`~gpim_tpu_torch.parallel.distributed.launch_workers`).

Usage::

    python -m gpim_tpu_torch.parallel.mp_worker <scenario>... [--spec FILE]
        --rank R --world N --address tcp://127.0.0.1:PORT --out DIR
        [--backend gloo|nccl] [--device cuda|cpu]

Every rank joins the world, runs the same program on the same data and
writes what it got to ``DIR``, scenario after scenario. Scenarios:

- ``multitask``: :func:`multichip.dryrun` on the world's ('task', 'grid')
  mesh, its partitioning checks included; writes
  ``multitask_result_r<R>.npz`` (loss, mean);
- ``vfe``: the public ``reconstructor(..., sparse=True, mesh=True)`` flow on
  a small 2D problem, data rows sharded over 'grid', which must issue its
  all-reduces; writes ``vfe_result_r<R>.npz`` (loss, lengthscale, mean,
  sd);
- ``spec``: the runs a JSON file lists (``--spec``), each a public model
  built from the arrays of one ``.npz``; writes ``<name>_r<R>.npz`` (the
  results) and ``<name>_r<R>.json`` (walls, kernel launches and calls,
  collectives) for each.

Each model runs on the rank's card (``cuda:{rank % device_count}``: ranks
may share one), and without a CUDA device the worker exits with an error;
``--device cpu`` runs on the CPU, as the CPU tests and
:func:`~gpim_tpu_torch.parallel.distributed.dryrun_multiprocess` ask. The
backend defaults to NCCL on the card and gloo on the CPU; two ranks that
share one card need ``--backend gloo``.

A spec file::

    {"arrays": "inputs.npz",
     "runs": [{"name": "eels64", "model": "vreconstructor",
               "args": ["X", "Y", "X_full"],
               "kwargs": {"kernel": "RBF", "independent": true},
               "mesh": [2, 1],          # (task, grid); true: the world
               "action": "run",         # or "train", "vfe_grad", "bo"
               "repeat": 1}]}

A kwargs value ``{"array": key}`` is that array of the ``.npz``.
"""

import argparse
import json
import os
import time

import numpy as np


def _toy_vfe_data():
    """A deterministic 16x16 2D problem with 40% of the pixels missing."""
    from gpim_tpu_torch import utils
    rng = np.random.RandomState(0)
    Z = np.exp(-((np.arange(16)[:, None] - 8.0) ** 2
                 + (np.arange(16) - 6.0) ** 2) / 18.0)
    Z = Z + 0.02 * rng.randn(16, 16)
    Z[rng.rand(16, 16) < 0.4] = np.nan
    return utils.get_sparse_grid(Z), Z, utils.get_full_grid(Z)


def _run_multitask(out, rank, device):
    from gpim_tpu_torch.parallel import multichip
    loss, mean = multichip.dryrun(device=device)
    np.savez(os.path.join(out, "multitask_result_r%d.npz" % rank),
             loss=loss, mean=mean)


def _run_vfe(out, rank, device):
    from gpim_tpu_torch import reconstructor
    from gpim_tpu_torch.parallel import distributed
    X, Z, X_full = _toy_vfe_data()
    model = reconstructor(X, Z, X_full, kernel="RBF", sparse=True,
                          indpoints=12, iterations=6, verbose=0,
                          mesh=True, precision="double", seed=0,
                          use_gpu=device != "cpu")
    assert model._rows[3] is not None, "VFE rows were expected to shard"
    distributed.reset_collective_counts()
    model.train()
    if not any(k.startswith("all_reduce")
               for k in distributed.collective_counts()):
        raise AssertionError("row-sharded VFE training issued no "
                             "all-reduce: the cross-rank sums vanished")
    mean, sd = model.predict()
    assert np.isfinite(model.losses).all(), model.losses
    assert np.isfinite(mean).all() and np.isfinite(sd).all()
    np.savez(os.path.join(out, "vfe_result_r%d.npz" % rank),
             loss=model.losses,
             lengthscale=model.hyperparams["lengthscale"][-1],
             mean=mean, sd=sd)


def _mesh_of(run):
    from gpim_tpu_torch.parallel import multichip
    mesh = run.get("mesh", True)
    if isinstance(mesh, list):
        return multichip.make_mesh_2d(task_axis=int(mesh[0]))
    return mesh


def _build(run, arrays, device, out, rank):
    import gpim_tpu_torch
    kw = {k: (arrays[v["array"]] if isinstance(v, dict) else v)
          for k, v in run.get("kwargs", {}).items()}
    kw["mesh"] = _mesh_of(run)
    kw.setdefault("verbose", 0)
    if device == "cpu":
        kw["use_gpu"] = False
    args = [arrays[a] for a in run["args"]]
    if run["model"] == "boptimizer":
        args.append(None)          # the target: measurements are simulated
        # its saved results go beside this rank's outputs
        kw.setdefault("filename", os.path.join(
            out, "%s_bo_r%d" % (run["name"], rank)))
    return getattr(gpim_tpu_torch, run["model"])(*args, **kw)


def _vfe_grad(model):
    """The VFE bound's gradients at the model's current parameters, on this
    rank's rows (the whole bound's, through the collectives)."""
    from gpim_tpu_torch.gpreg import engine
    X, y, mask, group = model._rows
    u = {k: v.detach().clone().requires_grad_(True)
         for k, v in model.u.items()}
    loss = engine.vfe_loss(u, X, y, mask, model._bounds(), model.jitter,
                           kernel=model.kernel_type, group=group)
    loss.backward()
    out = {"loss": loss.detach().cpu().numpy()}
    out.update({"grad_" + k: v.grad.cpu().numpy() for k, v in u.items()})
    return out


def _results(run, model):
    action = run.get("action", "run")
    if action == "vfe_grad":
        return _vfe_grad(model)
    if action == "train":
        model.train()
        out = {"losses": np.asarray(model.losses)}
        out.update({"hp_" + k: np.asarray(v)
                    for k, v in model.hyperparams.items()})
        return out
    if action == "bo":
        model.run()
        m = model.surrogate_model
        mean, sd = model.gp_predictions[-1]
        out = {"vals_all": np.asarray(model.vals_all, float),
               "indices_all": np.asarray(model.indices_all),
               "mean": mean, "sd": sd, "losses": m.losses}
        out.update({"hp_" + k: np.asarray(v)
                    for k, v in m.hyperparams.items()})
        return out
    mean, sd, hp = model.run()
    out = {"mean": mean, "sd": sd, "losses": model.losses}
    out.update({"hp_" + k: np.asarray(v) for k, v in hp.items()})
    return out


def _run_spec(spec_path, out, rank, device):
    import torch
    from gpim_tpu_torch.ops import gram_kernels as gk
    from gpim_tpu_torch.parallel import distributed
    with open(spec_path) as f:
        spec = json.load(f)
    arrays = dict(np.load(os.path.join(os.path.dirname(spec_path),
                                       spec["arrays"])))
    kernels = (gk.sqdist, gk.masked_system, gk.rbf_bwd_reductions)
    for run in spec["runs"]:
        walls = []
        for _ in range(int(run.get("repeat", 1))):
            for fn in kernels:
                fn.launches = 0
            distributed.reset_collective_counts()
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with gk.log_calls() as calls:
                model = _build(run, arrays, device, out, rank)
                res = _results(run, model)
            if device != "cpu":
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        shapes = {}
        for name, _, shape in calls:
            key = "%s %s" % (name, "x".join(str(s) for s in shape))
            shapes[key] = shapes.get(key, 0) + 1
        np.savez(os.path.join(out, "%s_r%d.npz" % (run["name"], rank)),
                 **res)
        with open(os.path.join(out, "%s_r%d.json" % (run["name"], rank)),
                  "w") as f:
            json.dump({"wall_s": walls,
                       "launches": {fn.__name__: fn.launches
                                    for fn in kernels},
                       "calls": shapes,
                       "collectives": distributed.collective_counts(),
                       "device": str(getattr(model, "surrogate_model",
                                             model).device)}, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("scenarios", nargs="+",
                    choices=("multitask", "vfe", "spec"))
    ap.add_argument("--spec")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--address", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--backend", choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    import torch
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    os.makedirs(a.out, exist_ok=True)
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    from gpim_tpu_torch.parallel import distributed
    backend = a.backend or ("nccl" if a.device == "cuda" else "gloo")
    distributed.initialize(a.address, a.world, a.rank, backend=backend)
    try:
        for scenario in a.scenarios:
            if scenario == "multitask":
                _run_multitask(a.out, a.rank, a.device)
            elif scenario == "vfe":
                _run_vfe(a.out, a.rank, a.device)
            else:
                _run_spec(a.spec, a.out, a.rank, a.device)
    finally:
        torch.distributed.destroy_process_group()
    print("mp_worker %s rank %d/%d: OK" % (" ".join(a.scenarios), a.rank,
                                            a.world), flush=True)


if __name__ == "__main__":
    main()
