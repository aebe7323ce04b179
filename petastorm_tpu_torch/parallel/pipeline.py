"""Pipeline parallelism (pp): GPipe-style microbatched execution over a mesh
axis, twin of ``petastorm_tpu/parallel/pipeline.py``.

The model's layers are split into S stages, one per rank of the mesh's
``stage`` axis; the batch is split into M microbatches that flow through
the stages in a skewed schedule (stage s runs microbatch ``t - s`` at tick
t), activations hopping stage to stage by
:func:`~petastorm_tpu_torch.parallel.collectives.ring_shift` (JAX's
``ppermute`` ``i -> i + 1``). After the ``S + M - 1`` fill-and-drain ticks
every microbatch has passed every stage. Public recipe: GPipe
(arXiv:1811.06965), SPMD-style as the JAX package runs it: every stage runs
the same program, the per-stage parameters are stacked ``[S, ...]`` and
each rank takes its slice, and masking replaces control flow.

That masking is what keeps the collectives matched, forward and backward:

- every rank runs every tick, bubble ticks included, and shifts its output
  at each one, so each rank calls the same sequence of shifts;
- stage 0 takes its fresh microbatch with ``torch.where`` over the
  activation it received, never by a Python branch: the received tensor
  stays in its graph, so the backward of every shift runs on every rank
  (the shift's backward is a send and a receive, and a rank that skipped
  one would leave its neighbour waiting);
- the last stage's outputs leave through
  :func:`~petastorm_tpu_torch.parallel.collectives.reduce_from_group` (sum
  forward, identity backward: JAX's ``psum`` of the masked copies), so
  every rank holds the outputs and computes the same loss, whose gradient
  is then counted once.

The bubble fraction is ``(S-1)/(S+M-1)``: raise ``num_microbatches`` to
amortise it. The outputs equal running the stages one after another
(tested). Compose it with any ``stage_fn(stage_params, activation) ->
activation`` that keeps the activation's shape.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from petastorm_tpu_torch.parallel.collectives import reduce_from_group, ring_shift


def pipeline_spmd(stage_fn, stage_params, microbatches, group):
    """Run the pipeline on this rank, one stage of ``group``.

    :param stage_fn: ``(stage_params, act) -> act`` applied by every stage to
        its current microbatch activation (same shapes in and out).
    :param stage_params: THIS stage's parameters (the rank's slice of the
        stacked parameters).
    :param microbatches: ``[M, mb, ...]`` the full microbatched input, the
        same on every stage (stage 0 ingests microbatch t at tick t).
    :param group: the stage ranks' process group, ``None`` for one stage.
    :returns: ``[M, mb, ...]`` outputs, the same on every stage.
    """
    n_stages = 1 if group is None else dist.get_world_size(group)
    stage = 0 if group is None else dist.get_rank(group)
    num_mb = microbatches.shape[0]
    device = microbatches.device
    first = torch.tensor(stage == 0, device=device)
    act = torch.zeros_like(microbatches[0])
    out = [torch.zeros_like(microbatches[0]) for _ in range(num_mb)]
    ticks = n_stages + num_mb - 1
    for t in range(ticks):
        # stage 0 ingests a fresh microbatch; the later stages take what
        # arrived from the previous stage on the last tick
        inp = torch.where(first, microbatches[min(t, num_mb - 1)], act)
        y = stage_fn(stage_params, inp)
        # stage s holds microbatch t - s at tick t; outside [0, M) it is the
        # pipeline's bubble: computed anyway, not written. A masked write on
        # every stage keeps each tick's output in every rank's graph
        mb_i = t - stage
        mb_w = min(max(mb_i, 0), num_mb - 1)
        write = torch.tensor(stage == n_stages - 1 and 0 <= mb_i < num_mb, device=device)
        out[mb_w] = torch.where(write, y, out[mb_w])
        if t < ticks - 1:  # the last tick's shift would feed no tick
            act = ring_shift(y, group)
    # the results live on the last stage (zeros elsewhere); the sum gives
    # every stage the same outputs
    return reduce_from_group(torch.stack(out), group)


def make_pipelined_apply(mesh, stage_fn, stage_axis='stage', num_microbatches=None):
    """``apply(stacked_params, x) -> y`` running ``stage_fn`` as a pipeline
    over ``mesh[stage_axis]``.

    ``stacked_params``: a tuple of tensors, each with a leading ``[S, ...]``
    stage axis (S = the mesh axis size, one stage per rank): each rank runs
    with its slice ``[stage]``, so the gradient of a stacked tensor is
    nonzero in this rank's row only. ``x``: the ``[B, ...]`` global batch,
    the same on every rank of the axis (``data_sharding(mesh,
    batch_axes=())`` stages it so), with ``B`` divisible by
    ``num_microbatches`` (default S, the fewest that keep every stage busy
    at steady state).
    """
    from petastorm_tpu_torch.parallel.mesh import axis_group, axis_size

    n_stages = axis_size(mesh, stage_axis)
    num_mb = num_microbatches or n_stages
    group = axis_group(mesh, stage_axis)
    stage = mesh.get_local_rank(stage_axis)

    def apply(stacked_params, x):
        # slicing would happily take a WRONG stage count (4 stacked stages
        # over a 2-rank axis would run stages 0 and 1 and silently compute
        # garbage): only an exact match is accepted
        for i, leaf in enumerate(stacked_params):
            if leaf.shape[0] != n_stages:
                raise ValueError(
                    'stacked stage params leaf [{}] has leading dim {} but the {!r} mesh axis '
                    'has {} stages; one stage per device is required'.format(
                        i, leaf.shape[0], stage_axis, n_stages))
        b = x.shape[0]
        if b % num_mb:
            raise ValueError('batch ({}) must be divisible by num_microbatches ({})'.format(
                b, num_mb))
        mb = x.reshape((num_mb, b // num_mb) + tuple(x.shape[1:]))
        out = pipeline_spmd(stage_fn, tuple(leaf[stage] for leaf in stacked_params), mb, group)
        return out.reshape((b,) + tuple(out.shape[2:]))

    return apply
