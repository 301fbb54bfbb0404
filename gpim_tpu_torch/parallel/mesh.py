"""
Device meshes for the ``mesh=`` option of the public models (counterpart
of ``gpim_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group: 1D ``('grid',)`` for ``reconstructor``,
``skreconstructor`` and ``boptimizer``, 2D ``('task', 'grid')`` for
``vreconstructor`` (:func:`gpim_tpu_torch.parallel.multichip.make_mesh_2d`).
One rank is one process (see :mod:`gpim_tpu_torch.parallel.distributed`):

- prediction tiles shard their rows over 'grid' (each rank computes its
  rows against the replicated factorization, then the rows are gathered);
- multi-output channels shard over 'task';
- a single model's Cholesky stays rank-local, as in ``gpim_tpu``; the VFE's
  data rows shard over 'grid' with its (m, m) sums all-reduced.

Sharding is a layout, never a change to the math. ``mesh=`` takes a
``DeviceMesh`` carrying the axes a model needs (used as is), ``True`` (the
whole world) or an int, which must equal the world size (``gpim_tpu`` takes
the first n of its devices, which one process a rank cannot do without idle
ranks). With no process group initialized, ``True`` or ``1`` is a one-rank
mesh with no collectives (:class:`LocalMesh`).
"""

import warnings

import numpy as np
import torch
import torch.distributed as dist

from gpim_tpu_torch.parallel import distributed

__all__ = ["LocalMesh", "local_device_count", "get_mesh", "build_mesh",
           "resolve_mesh", "axis_size", "axis_rank", "axis_group",
           "shard_batch", "replicate", "shard_chunk_rows", "row_block",
           "shard_gather", "predict_rows"]


class LocalMesh:
    """A one-rank mesh for a process with no process group: every axis has
    size 1 and no group, so every collective is the identity."""

    def __init__(self, mesh_dim_names):
        self.mesh_dim_names = tuple(mesh_dim_names)
        self.shape = (1,) * len(self.mesh_dim_names)

    def get_group(self, mesh_dim=None):
        return None

    def get_local_rank(self, mesh_dim=None):
        return 0

    def __repr__(self):
        return "LocalMesh(%r)" % (self.mesh_dim_names,)


def local_device_count():
    return torch.cuda.device_count()


_MESHES = {}


def build_mesh(shape, names):
    """The ``DeviceMesh`` of ``shape`` with axes ``names`` over the world,
    built once per process group (building one is collective); a
    :class:`LocalMesh` without a process group."""
    if not distributed.is_initialized():
        if any(s != 1 for s in shape):
            raise ValueError("a mesh of shape %s needs an initialized "
                             "process group (parallel.distributed."
                             "initialize)" % (tuple(shape),))
        return LocalMesh(names)
    from torch.distributed.device_mesh import init_device_mesh
    key = (id(dist.group.WORLD), tuple(shape), tuple(names))
    if key not in _MESHES:
        device_type = ("cuda" if dist.get_backend() == "nccl" else "cpu")
        _MESHES[key] = init_device_mesh(device_type, tuple(shape),
                                        mesh_dim_names=tuple(names))
    return _MESHES[key]


def _check_count(n_devices):
    world = distributed.process_count()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            "mesh=%r: an integer mesh must equal the world size (%d); one "
            "process runs one rank, so a smaller mesh would leave ranks "
            "idle" % (n_devices, world))
    return world


def get_mesh(n_devices=None, axis_name="grid"):
    """A 1D mesh over every rank of the world (``n_devices``, when given,
    must equal the world size)."""
    return build_mesh((_check_count(n_devices),), (axis_name,))


def resolve_mesh(mesh_arg, axis_names=("grid",)):
    """Normalize the public ``mesh=`` kwarg: a mesh (``DeviceMesh`` or
    :class:`LocalMesh`) carrying every axis of ``axis_names`` is used as
    is; ``True`` or an int (the world size) builds the world's mesh, 1D
    over ``axis_names[0]`` or, for ``('task', 'grid')``, the squarest
    task-major split of :func:`multichip.make_mesh_2d`."""
    if hasattr(mesh_arg, "mesh_dim_names"):
        names = tuple(mesh_arg.mesh_dim_names or ())
        missing = [a for a in axis_names if a not in names]
        if missing:
            raise ValueError("mesh must have axes %r; got axes %r"
                             % (tuple(axis_names), names))
        return mesh_arg
    n = None if mesh_arg is True else int(mesh_arg)
    if tuple(axis_names) == ("task", "grid"):
        from gpim_tpu_torch.parallel.multichip import make_mesh_2d
        return make_mesh_2d(n)
    if len(axis_names) != 1:
        raise ValueError("cannot build a mesh with axes %r"
                         % (tuple(axis_names),))
    return get_mesh(n, axis_names[0])


def _dim(mesh, axis_name):
    return mesh.mesh_dim_names.index(axis_name)


def axis_size(mesh, axis_name):
    return int(mesh.shape[_dim(mesh, axis_name)])


def axis_rank(mesh, axis_name):
    """This rank's coordinate along the mesh axis ``axis_name``."""
    return int(mesh.get_local_rank(axis_name))


def axis_group(mesh, axis_name):
    """The process group of the mesh axis ``axis_name`` (None on a
    :class:`LocalMesh`)."""
    return mesh.get_group(axis_name)


def shard_batch(t, mesh, axis_name="grid"):
    """This rank's contiguous block of the leading axis of ``t`` (a tensor
    every rank holds in full), sharded over ``axis_name``."""
    return distributed.put_with(t, mesh, axis_name, device=t.device,
                                dtype=t.dtype)


def replicate(tree, mesh):
    """Every tensor of a dict (or a tensor) made equal on all ranks of the
    mesh: rank 0's value, broadcast. SPMD ranks each hold their own copy
    of a replicated value; this makes it one, whatever each process
    computed (the identity on a :class:`LocalMesh`)."""
    group = None if isinstance(mesh, LocalMesh) else dist.group.WORLD
    if isinstance(tree, dict):
        return {k: distributed.broadcast(v, group) for k, v in tree.items()}
    return distributed.broadcast(tree, group)


def shard_chunk_rows(chunks, mesh, axis_name="grid"):
    """This rank's rows of every (n_chunks, chunk, ...) prediction tile,
    sharded over the mesh axis: returns ``(tiles, True)``. When the chunk
    size does not divide the axis, returns ``(chunks, False)`` with a
    warning, once per message: prediction then runs replicated (every rank
    computes all rows), as ``gpim_tpu`` does (``mesh.py:76-97`` there)."""
    if not _tiles_divide(chunks, mesh, axis_name):
        return chunks, False
    return row_block(chunks, axis_size(mesh, axis_name),
                     axis_rank(mesh, axis_name), axis=1), True


def _tiles_divide(chunks, mesh, axis_name):
    n_dev = axis_size(mesh, axis_name)
    if chunks.shape[1] % n_dev:
        _warn_replicated_once(
            "prediction tiles of %d rows do not divide the %d-rank %r "
            "mesh axis - prediction runs REPLICATED (every rank computes "
            "all rows). Use a rank count that divides the chunk size (e.g. "
            "a power of two) to shard it."
            % (chunks.shape[1], n_dev, axis_name))
        return False
    return True


def row_block(x, n, r, axis=0):
    """Rank ``r``'s block of ``x`` (a tensor or numpy array) along ``axis``
    split into ``n`` equal blocks, contiguous; where ``n`` does not divide
    the axis, the axis is first padded to a multiple of ``n`` by repeating
    its last entry (the padded rows are computed and dropped, as GSPMD's
    uneven sharding does for ``gpim_tpu``)."""
    size = x.shape[axis]
    per = -(-size // n)
    if per * n != size:
        last = x.narrow(axis, size - 1, 1) if torch.is_tensor(x) else \
            x.take([size - 1], axis=axis)
        reps = [1] * x.ndim
        reps[axis] = per * n - size
        pad = last.repeat(*reps) if torch.is_tensor(x) else \
            np.tile(last, reps)
        x = torch.cat([x, pad], axis) if torch.is_tensor(x) else \
            np.concatenate([x, pad], axis)
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(r * per, (r + 1) * per)
    block = x[tuple(idx)]
    return block.contiguous() if torch.is_tensor(block) else \
        np.ascontiguousarray(block)


def shard_gather(fn, x, mesh, axis=0, axis_name="grid"):
    """Run ``fn(block) -> (mean, var)`` on this rank's :func:`row_block` of
    ``x`` along ``axis``, sharded over the mesh axis ``axis_name``, and
    gather both outputs in one all-gather; every rank gets the outputs of
    ``fn(x)``. Each output's leading axis runs over x's axes up to and
    including ``axis`` (row-major), trailing per-row values folded into it
    or kept as further axes; where the mesh axis does not divide ``axis``,
    the padded rows are dropped after the gather."""
    lead = int(np.prod(x.shape[:axis], dtype=np.int64))
    size = x.shape[axis]
    mean, var = fn(row_block(x, axis_size(mesh, axis_name),
                             axis_rank(mesh, axis_name), axis))
    both = torch.stack([mean, var])
    rows = -(-size // axis_size(mesh, axis_name))
    both = both.reshape((2, lead, rows, -1))
    both = distributed.all_gather(both, axis_group(mesh, axis_name), dim=2)
    both = both[:, :, :size].reshape((2, -1) + tuple(mean.shape[1:]))
    return both[0], both[1]


def predict_rows(predict, chunks, mesh, axis_name="grid"):
    """Run ``predict(tiles) -> (mean, var)`` (each (n_chunks * rows, ...))
    on this rank's rows of the prediction tiles and gather the rows of
    both outputs (:func:`shard_gather`); every rank gets the full (n_chunks
    * chunk, ...) results. Replicated, with a warning, where
    :func:`shard_chunk_rows` says so."""
    if not _tiles_divide(chunks, mesh, axis_name):
        return predict(chunks)
    return shard_gather(predict, chunks, mesh, axis=1, axis_name=axis_name)


_warned_replicated = set()


def _warn_replicated_once(msg):
    if msg not in _warned_replicated:
        _warned_replicated.add(msg)
        warnings.warn(msg, UserWarning, stacklevel=3)
