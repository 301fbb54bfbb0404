"""
Multi-process execution on ``torch.distributed`` (counterpart of
``gpim_tpu/parallel/distributed.py``).

The model of execution is PyTorch's SPMD idiom, one process per card, as
``torchrun`` launches it; ``gpim_tpu`` runs one controller over the local
devices and one per host across hosts (``distributed.py:1-30`` there). So:

- every process calls :func:`initialize` (or ``torchrun`` does the
  rendezvous and :func:`initialize` reads its environment), after which the
  default process group spans every rank of the job; a rank computes on
  ``cuda:{local_rank % device_count}``, and ranks may share a card;
- every process builds the SAME models from the SAME host arrays (the
  replicated-host-data convention of ``gpim_tpu``'s ``put_with``) and takes
  its own share with :func:`put_with`;
- results come back through :func:`fetch`, an all-gather, so every rank
  holds the full host value.

Collectives go through the helpers below, one for each of all-reduce,
all-gather and all-to-all, plus a broadcast for :func:`replicate
<gpim_tpu_torch.parallel.mesh.replicate>`. Each counts its calls and bytes by
operation and backend (:func:`collective_counts`): the port's counterpart of
``gpim_tpu``'s checks of the collectives in a compiled program
(``multichip.assert_partitioned_predict``, ``mp_worker._run_vfe``). The
transport follows the group's backend, never an exception: NCCL takes CUDA
tensors; gloo takes CPU tensors, and a CUDA tensor on a gloo group is staged
through the host explicitly (gloo's CUDA support does not cover every
collective, and NCCL refuses two ranks on one card), which the counter
records.

Gradients across a row shard use the conjugate pair of autograd functions
:func:`copy_to_shards` (identity forward, all-reduce backward) and
:func:`reduce_from_shards` (all-reduce forward, identity backward):
replicated parameters enter row-local work through the first, row sums
leave it through the second, so every replicated term of a loss is
differentiated once and every row-local term once per rank. (GSPMD inserts
the same pair for ``gpim_tpu`` implicitly.) With ``group=None`` both are
identity functions that still record an autograd node, so an unsharded run
and a one-rank run take the same graph.

Validation without a multi-card machine: :func:`dryrun_multiprocess` spawns
real processes on localhost (gloo, CPU) that jointly train the
task-sharded multi-output model and the row-sharded VFE, and checks them
against each other and against a one-process run of the same program.
"""

import os
import subprocess
import sys
import tempfile
import threading
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize", "is_initialized", "process_index", "process_count",
    "local_rank", "put_with", "fetch",
    "all_reduce", "all_gather", "all_to_all", "broadcast",
    "collective_counts", "reset_collective_counts",
    "copy_to_shards", "reduce_from_shards", "dryrun_multiprocess",
]


def initialize(address=None, world_size=None, rank=None, *, backend=None):
    """Join (or start, for rank 0) the default process group.

    ``address`` is an init method (``"tcp://host:port"``, ``"env://"``) or
    a coordinator ``"host:port"``; without one the ``torchrun`` environment
    (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``) is read. ``backend``
    defaults to ``nccl`` when CUDA is available and ``gloo`` otherwise.
    When CUDA is available the rank's current device becomes
    ``cuda:{local_rank % device_count}``. A failed rendezvous raises.

    One card a process::

        torchrun --nproc-per-node=4 my_script.py
        # in my_script.py
        from gpim_tpu_torch.parallel import distributed
        distributed.initialize()
        model = gpim_tpu_torch.reconstructor(X, y, Xtest, mesh=True)
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if address is None:
        address = "env://"
    elif "://" not in address:
        address = "tcp://" + address
    kwargs = {}
    if world_size is not None:
        kwargs = {"world_size": int(world_size), "rank": int(rank)}
    if torch.cuda.is_available():
        r = int(rank) if rank is not None else int(os.environ.get("RANK", 0))
        torch.cuda.set_device(local_rank(r) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=address,
                            timeout=timedelta(seconds=600), **kwargs)


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def process_index():
    return dist.get_rank() if is_initialized() else 0


def process_count():
    return dist.get_world_size() if is_initialized() else 1


def local_rank(rank=None):
    """This process's rank on its host: ``LOCAL_RANK`` under ``torchrun``,
    else the global rank (one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_index() if rank is None else int(rank)


def put_with(arr, mesh=None, axis_name=None, *, device, dtype=None):
    """This rank's share of a host array, as a tensor on ``device``: the
    contiguous block of the leading axis that its coordinate on the mesh
    axis ``axis_name`` owns, or the whole array when ``axis_name`` is None
    (replicated). Every rank passes the same full array; the leading axis
    must divide the axis size."""
    t = torch.as_tensor(arr if torch.is_tensor(arr) else np.asarray(arr),
                        device=device, dtype=dtype)
    if axis_name is None:
        return t
    from gpim_tpu_torch.parallel.mesh import axis_rank, axis_size
    size, r = axis_size(mesh, axis_name), axis_rank(mesh, axis_name)
    if t.shape[0] % size:
        raise ValueError("leading axis of %d rows does not divide the %d "
                         "ranks of mesh axis %r" % (t.shape[0], size,
                                                    axis_name))
    step = t.shape[0] // size
    return t[r * step:(r + 1) * step].contiguous()


def fetch(t, mesh=None, axis_name=None, dim=0):
    """The full host value (numpy) of a tensor sharded along ``dim`` over
    the mesh axis ``axis_name``, identical on every rank; a replicated
    tensor (``axis_name`` None) is copied out. A collective: every rank
    calls it on the same tensors in the same order."""
    if axis_name is not None:
        from gpim_tpu_torch.parallel.mesh import axis_group
        t = all_gather(t, axis_group(mesh, axis_name), dim=dim)
    return t.detach().cpu().numpy().copy()


# --------------------------------------------------------------------------
# collectives, counted
# --------------------------------------------------------------------------

_COUNTS = {}


def collective_counts():
    """``{"op@backend": {"calls", "bytes", "staged_calls", "staged_bytes"}}``
    since the last :func:`reset_collective_counts`; bytes are this rank's
    payload (its input tensor), staged ones went through the host."""
    return {k: dict(v) for k, v in _COUNTS.items()}


def reset_collective_counts():
    _COUNTS.clear()


def _transport(op, t, group, fn):
    """Run ``fn(tensor) -> result`` on ``t`` over ``group`` by the group's
    backend: NCCL takes a CUDA tensor, gloo a CPU one, and a CUDA tensor on
    gloo is copied to the host and back. Counts the call."""
    backend = dist.get_backend(group)
    staged = backend == "gloo" and t.is_cuda
    if backend == "nccl" and not t.is_cuda:
        raise ValueError("%s: an NCCL group takes CUDA tensors" % op)
    nbytes = t.numel() * t.element_size()
    c = _COUNTS.setdefault("%s@%s" % (op, backend), {
        "calls": 0, "bytes": 0, "staged_calls": 0, "staged_bytes": 0})
    c["calls"] += 1
    c["bytes"] += nbytes
    if staged:
        c["staged_calls"] += 1
        c["staged_bytes"] += nbytes
        return fn(t.detach().cpu()).to(t.device)
    return fn(t.detach().contiguous())


def all_reduce(t, group):
    """Sum of ``t`` over the ranks of ``group`` (a new tensor); ``t``
    itself with ``group=None``."""
    if group is None:
        return t

    def run(x):
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x
    return _transport("all_reduce", t, group, run)


def all_gather(t, group, dim=0):
    """The ranks' tensors of ``group`` concatenated along ``dim`` in rank
    order (every rank passes the same shape); ``t`` with ``group=None``."""
    if group is None:
        return t

    def run(x):
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)
    return _transport("all_gather", t, group, run)


def all_to_all(t, group):
    """Tiled all-to-all over the leading axis: block ``j`` of this rank's
    ``t`` (split evenly into ``size`` blocks) goes to rank ``j``, and block
    ``j`` of the result came from rank ``j``; ``t`` with ``group=None``."""
    if group is None:
        return t

    def run(x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out
    return _transport("all_to_all", t, group, run)


def broadcast(t, group):
    """The value of ``t`` on the first rank of ``group``, on every rank;
    ``t`` with ``group=None``."""
    if group is None:
        return t

    def run(x):
        x = x.clone()
        dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
        return x
    return _transport("broadcast", t, group, run)


class _CopyToShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group) if group is not None else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_shards(x, group):
    """``x`` unchanged forward; its gradient summed over ``group``
    backward. A replicated value enters row-local work through this."""
    return _CopyToShards.apply(x, group)


def reduce_from_shards(x, group):
    """``x`` summed over ``group`` forward; the gradient passed through
    unchanged backward. A row-local partial sum leaves through this."""
    return _ReduceFromShards.apply(x, group)


# --------------------------------------------------------------------------
# multi-process dryrun: real separate processes on localhost (gloo, CPU)
# --------------------------------------------------------------------------

_ISSUED_PORTS = set()
_PORT_LOCK = threading.Lock()


def _free_port():
    """A currently free localhost port, never one this process handed out
    before (worlds started at once must not meet on one port). Racy against
    other programs (the probe closes before rank 0 binds it), so callers
    retry on a bind failure; see _coordinator_bind_failed."""
    import socket
    with _PORT_LOCK:
        while True:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            if port not in _ISSUED_PORTS:
                _ISSUED_PORTS.add(port)
                return port


def _coordinator_bind_failed(tails):
    """True when the workers' logs show rank 0 lost the _free_port race."""
    t = "\n".join(tails).lower()
    return "address already in use" in t or "failed to bind" in t


def _wait_all(procs, timeout):
    """Wait on every worker under ONE shared deadline; on timeout (a peer
    died before the rendezvous and the rest block in it) kill the
    stragglers, so none outlives the caller, and raise."""
    deadline = time.monotonic() + timeout
    try:
        return [p.wait(timeout=max(0.0, deadline - time.monotonic()))
                for p in procs]
    except Exception:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            try:
                p.wait(timeout=30)
            except Exception:
                pass
        raise


def _worker_env():
    env = dict(os.environ)
    # `python -m gpim_tpu_torch...` must resolve this package whatever the
    # caller's working directory
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.setdefault("OMP_NUM_THREADS", "2")
    return env


def _start_world(args, n_procs, outdir, tag):
    os.makedirs(outdir, exist_ok=True)
    address = "tcp://127.0.0.1:%d" % _free_port()
    procs, paths = [], []
    for r in range(n_procs):
        paths.append(os.path.join(outdir, "%s_r%d.log" % (tag, r)))
        with open(paths[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "gpim_tpu_torch.parallel.mp_worker"]
                + list(args) + ["--rank", str(r), "--world", str(n_procs),
                                "--address", address, "--out", outdir],
                env=_worker_env(), stdout=log, stderr=subprocess.STDOUT))
    return procs, paths


def launch_workers(worlds, timeout=600):
    """Run worlds of ``python -m gpim_tpu_torch.parallel.mp_worker <args>
    --rank r --world n --address a --out outdir`` processes, all at once,
    and wait for every process under one deadline. ``worlds`` is a list of
    ``(args, n_procs, outdir, tag)``. A world whose rank 0 lost the port
    race is started again on a fresh port (twice at most); any other
    failure raises with the tail of every log of that world."""
    pending = [(w, 0) for w in worlds]
    deadline = time.monotonic() + timeout
    while pending:
        started = [(w, attempt, _start_world(*w)) for w, attempt in pending]
        pending = []
        allprocs = [p for _, _, (procs, _) in started for p in procs]
        try:
            _wait_all(allprocs, max(1.0, deadline - time.monotonic()))
        finally:
            for p in allprocs:
                if p.poll() is None:
                    p.kill()
        for w, attempt, (procs, paths) in started:
            rc = [p.returncode for p in procs]
            if not any(rc):
                continue
            tails = []
            for r, path in enumerate(paths):
                with open(path) as f:
                    tails.append("--- rank %d (rc=%d) ---\n%s"
                                 % (r, rc[r], "".join(f.readlines()[-30:])))
            if attempt < 2 and _coordinator_bind_failed(tails):
                pending.append((w, attempt + 1))
                continue
            raise RuntimeError("%d-process world %r failed (rc=%s)\n%s"
                               % (w[1], w[3], rc, "\n".join(tails)))


def dryrun_multiprocess(n_procs=2, scenarios=("multitask", "vfe"),
                        timeout=600):
    """Spawn ``n_procs`` real processes (localhost rendezvous, gloo, CPU,
    float64) that jointly run each scenario of :mod:`mp_worker
    <gpim_tpu_torch.parallel.mp_worker>`:

    - 'multitask': the task-sharded independent multi-output train step and
      the row-sharded prediction (:func:`multichip.dryrun`), with its
      partitioning checks;
    - 'vfe': the public ``reconstructor(..., sparse=True, mesh=True)``
      flow with the data rows sharded over 'grid', which must issue its
      all-reduces.

    Then run the same scenarios in one process (a world of one) and assert
    that the ranks agree exactly and match the one-process run (the
    collectives change the order of sums, not the math). Raises on any
    failure; returns {scenario: {key: largest gap to one process}}.
    """
    out = {}
    with tempfile.TemporaryDirectory(prefix="gpim_torch_mp_") as tmp:
        ref_dir = os.path.join(tmp, "ref")
        args = list(scenarios) + ["--device", "cpu", "--backend", "gloo"]
        launch_workers([(args, n_procs, tmp, "world"),
                        (args, 1, ref_dir, "ref")], timeout=timeout)
        for scenario in scenarios:
            results = [np.load(os.path.join(
                tmp, "%s_result_r%d.npz" % (scenario, r)))
                for r in range(n_procs)]
            ref = np.load(os.path.join(ref_dir,
                                       "%s_result_r0.npz" % scenario))
            report = {}
            for key in ref.files:
                for r in range(1, n_procs):
                    np.testing.assert_array_equal(
                        results[r][key], results[0][key], err_msg=(
                            "%s/%s differs between ranks 0 and %d"
                            % (scenario, key, r)))
                np.testing.assert_allclose(
                    results[0][key], ref[key], rtol=1e-9, atol=1e-12,
                    err_msg="%s/%s: the %d-process run diverged from the "
                    "one-process run" % (scenario, key, n_procs))
                report[key] = float(np.max(np.abs(
                    results[0][key] - ref[key]))) if ref[key].size else 0.0
            out[scenario] = report
    return out
