"""Mesh and sharding helpers: twin of ``petastorm_tpu/parallel/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` over the devices of a pod
and lets XLA move data by sharding annotations. Here the "devices" of a
mesh are the ranks of a ``torch.distributed`` world, one process per card,
and the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
same axis names and the same axis-shape rules.

One thing differs by construction. In JAX one *host* reads one reader shard
and feeds all its devices, so the devices of one ``model``, ``seq``,
``expert`` or ``stage`` group see the same rows (JAX stages an MoE batch
``P('data')``, replicated over ``expert``, and a pipeline's input ``P()``,
replicated over ``stage``). With one process per card every rank reads, so
the ranks of one such group must read the same shard
(:func:`reader_shard_for_process` gives the *data* coordinate, not the rank)
and train on the same rows in the same order: a thread pool of several
workers delivers them in another order in each process, so staging onto a
:class:`DataSharding` whose replica group (the ranks outside the batch axes)
has more than one rank broadcasts the group's first rank's batch over it.

A sequence sharding (``data_sharding(mesh, seq_axis='seq')``, the twin of
``NamedSharding(mesh, P('data', 'seq', None))``) then keeps this rank's
slice of axis 1, the time axis: each rank of a ``('data', 'seq')`` mesh
holds ``[B/data, T/seq, ...]``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from petastorm_tpu_torch.device import resolve_device


def mesh_shape(axis_names, axis_shapes, n):
    """The mesh shape for ``n`` ranks: the JAX function's rules and errors.

    ``axis_shapes`` is a sequence aligned with ``axis_names`` or a dict
    ``{axis_name: size}``; ``None``/``-1`` entries (or a missing dict key, at
    most one) absorb the remaining ranks. ``None`` puts every rank on the
    first axis."""
    if axis_shapes is None:
        return [n] + [1] * (len(axis_names) - 1)
    if isinstance(axis_shapes, dict):
        unknown_names = set(axis_shapes) - set(axis_names)
        if unknown_names:
            raise ValueError('axis_shapes names {} not in axis_names {}'.format(
                sorted(unknown_names), axis_names))
        axis_shapes = [axis_shapes.get(name, -1) for name in axis_names]
    shapes = list(axis_shapes)
    if len(shapes) != len(axis_names):
        raise ValueError('axis_shapes and axis_names must have equal length')
    unknown = [i for i, s in enumerate(shapes) if s is None or s == -1]
    known = int(np.prod([s for s in shapes if s not in (None, -1)])) if shapes else 1
    if len(unknown) > 1:
        raise ValueError('At most one axis size may be None/-1')
    if unknown:
        if n % known:
            raise ValueError('{} ranks not divisible by fixed axis product {}'.format(n, known))
        shapes[unknown[0]] = n // known
    if int(np.prod(shapes)) != n:
        raise ValueError('Mesh shape {} does not use all {} ranks of the world'.format(shapes, n))
    return shapes


def _rank_device(device):
    """This rank's card: ``cuda:LOCAL_RANK`` (a launcher's), else
    ``cuda:rank % device_count``; an explicit index or the CPU is kept."""
    if device.type != 'cuda' or device.index is not None:
        return device
    if 'LOCAL_RANK' in os.environ:
        return torch.device('cuda', int(os.environ['LOCAL_RANK']))
    rank = dist.get_rank() if dist.is_initialized() else int(os.environ.get('RANK', 0))
    return torch.device('cuda', rank % torch.cuda.device_count())


def _init_world(device):
    """Create the default process group when none exists: NCCL for a card,
    gloo for the CPU; joined from a launcher's ``RANK``/``WORLD_SIZE``/
    ``MASTER_ADDR``, else a world of one on a ``HashStore``."""
    if dist.is_initialized():
        return
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if backend == 'nccl':
        # a graphed step under DDP needs it before the group exists
        # (PyTorch's CUDA graph notes)
        os.environ.setdefault('TORCH_NCCL_ASYNC_ERROR_HANDLING', '0')
    if all(k in os.environ for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR')):
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(axis_names=('data',), axis_shapes=None, device=None):
    """A ``DeviceMesh`` over the ranks of the world, with dimensions named
    ``axis_names`` and shaped by ``axis_shapes`` (:func:`mesh_shape`).

    :param device: ``None`` = CUDA (raises without it); ``'cpu'`` for gloo.
        The default process group is created when none exists (NCCL on a
        card, gloo on the CPU; a launcher's world, else a world of one), and
        this rank's card is made current.
    """
    device = resolve_device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(_rank_device(device))
    _init_world(device)
    shape = mesh_shape(tuple(axis_names), axis_shapes, dist.get_world_size())
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, tuple(shape), mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis):
    """The size of the mesh dimension named ``axis``."""
    names = mesh.mesh_dim_names
    if axis not in names:
        raise ValueError('mesh has no axis {!r} (axes {})'.format(axis, names))
    return mesh.shape[names.index(axis)]


def _coordinate(mesh, axes):
    """``(index, size)`` of this rank over ``axes``, row-major."""
    index, size = 0, 1
    for axis in axes:
        n = axis_size(mesh, axis)
        index, size = index * n + mesh.get_local_rank(axis), size * n
    return index, size


def axis_group(mesh, axis):
    """The process group of this rank along ``axis``, or ``None`` when the
    mesh has no such axis or it has one rank."""
    if axis not in mesh.mesh_dim_names or axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


@dataclasses.dataclass(frozen=True)
class DataSharding(object):
    """Where this rank's rows of a global batch go: the twin of a
    ``NamedSharding(mesh, P(batch_axes))``.

    ``index``/``size`` are this rank's data coordinate over ``batch_axes``
    (a tuple multiplies) and their size; ``device`` is this rank's device;
    ``replica_group`` is the group of the ranks that hold the same rows (the
    mesh axis outside ``batch_axes``), ``None`` when it has one rank.
    ``seq_index``/``seq_size`` are this rank's coordinate on the sequence
    axis and its size (0 and 1 without one): staging keeps slice
    ``seq_index`` of ``seq_size`` equal slices of axis 1."""
    mesh: object
    batch_axes: tuple
    device: torch.device
    index: int
    size: int
    replica_group: object = None
    seq_index: int = 0
    seq_size: int = 1


def data_sharding(mesh, batch_axes='data', seq_axis=None):
    """The :class:`DataSharding` that splits the leading (batch) dimension
    over ``batch_axes`` (an axis name or a tuple of them; ``()`` replicates
    it, as ``P()``: a pipeline's input on a ``('stage',)`` mesh) and, with
    ``seq_axis``, axis 1 (time) over that mesh axis."""
    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    batch_axes = tuple(batch_axes)
    seq = {}
    if seq_axis is not None:
        if seq_axis in batch_axes:
            raise ValueError('seq_axis {!r} is one of batch_axes {}'.format(seq_axis, batch_axes))
        seq_size = axis_size(mesh, seq_axis)  # raises for an axis the mesh lacks
        seq = {'seq_index': mesh.get_local_rank(seq_axis), 'seq_size': seq_size}
    index, size = _coordinate(mesh, batch_axes)
    replicas = [a for a in mesh.mesh_dim_names
                if a not in batch_axes and axis_size(mesh, a) > 1]
    if len(replicas) > 1:
        raise ValueError('the ranks that hold the same rows must lie on one mesh axis; '
                         'axes {} outside batch_axes {} have more than one rank'.format(
                             replicas, batch_axes))
    device = (torch.device('cuda', torch.cuda.current_device()) if mesh.device_type == 'cuda'
              else torch.device(mesh.device_type))
    return DataSharding(mesh, batch_axes, device, index, size,
                        mesh.get_group(replicas[0]) if replicas else None, **seq)


#: mesh axes whose ranks hold the same rows: one reader shard for the group
_SAME_ROWS_AXES = ('model', 'seq', 'expert', 'stage')


def reader_shard_for_process(mesh=None):
    """``(cur_shard, shard_count)`` for this rank's reader. With no mesh, or
    a mesh without a ``model``, ``seq``, ``expert`` or ``stage`` axis, that
    is ``(rank, world_size)``; with one it is the coordinate over the other
    axes, so the ranks of one such group read the same shard (as one JAX
    host feeds its devices)."""
    if mesh is None or not set(_SAME_ROWS_AXES) & set(mesh.mesh_dim_names):
        if not dist.is_initialized():
            return 0, 1
        return dist.get_rank(), dist.get_world_size()
    return _coordinate(mesh, [a for a in mesh.mesh_dim_names if a not in _SAME_ROWS_AXES])


def process_local_batch_size(global_batch_size, mesh=None):
    """Rows this rank's loader must produce per global batch: the global
    batch over the data size (the world size without a mesh or an axis of
    ranks that hold the same rows)."""
    size = reader_shard_for_process(mesh)[1]
    if global_batch_size % size:
        raise ValueError('global_batch_size {} not divisible by the data size {}'.format(
            global_batch_size, size))
    return global_batch_size // size


def make_global_batch(local_batch, sharding):
    """dict of this rank's numpy arrays -> dict of tensors on
    ``sharding.device``, equal on every rank of the replica group (and, on
    a sequence sharding, this rank's slice of axis 1). Non-numeric columns
    (strings, objects, datetimes) stay numpy."""
    from petastorm_tpu_torch.torch.infeed import stage_batch
    return stage_batch(local_batch, sharding)
