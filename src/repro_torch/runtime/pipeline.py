"""GPipe-style pipeline parallelism over a named mesh axis (port of
``repro.runtime.pipeline``).

Stages are mapped onto the coordinates of one mesh axis; microbatches
stream through with a cyclic shift along it (JAX's ``lax.ppermute``),
and bubbles are handled by masking.  Backward is plain autograd through
the schedule: the shift's backward is the reverse shift, so the gradient
of a pipelined loss is pipeline-parallel training with no extra
machinery.

Schedule: classic GPipe fill-drain, T = M + S - 1 ticks for M
microbatches over S stages; bubble fraction (S-1)/T.

Every rank runs the same graph: where JAX selects with ``jnp.where`` on
the stage index, the port does too (the condition a tensor, not a Python
branch), so each rank's backward runs the same reverse shifts in the
same order and no rank waits on a shift another rank skipped.
"""
from __future__ import annotations

import torch

from repro_torch import tree


class _Shift(torch.autograd.Function):
    """Send to the next stage, receive from the previous; the backward
    sends the cotangent the other way."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.shift(x, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.shift(g.contiguous(), ctx.axis, -1), None, None


class _Psum(torch.autograd.Function):
    """Sum over the axis (JAX's ``psum``).  The result is replicated over
    the axis and the caller's loss counts it once, so each rank's
    addend takes the result's cotangent as it is."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, (axis,), "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gpipe_apply(stage_fn, stage_params, x, *, mesh, axis: str = "stage",
                microbatches: int = 4):
    """Apply ``stage_fn`` through the S stages of ``axis``; every rank of
    the mesh calls it.

    stage_fn: (params_one_stage, h [mb, ...]) -> h [mb, ...] (same shape)
    stage_params: this rank's piece of a tree with leading dim S sharded
        over ``axis`` (``rules.shard`` with spec ``(axis,)``): leading
        dim 1, this stage's parameters
    x: [B, ...] with B % microbatches == 0, the same on every rank
    Returns stage_S-1(...stage_0(x)), on every rank."""
    nstages = mesh.axis_size(axis)
    b = x.shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not divide into {microbatches} "
                         "microbatches")
    mbs = x.reshape((microbatches, b // microbatches) + tuple(x.shape[1:]))
    t_total = microbatches + nstages - 1
    params_local = tree.tree_map(lambda a: a[0], stage_params)
    stage = mesh.coord(axis)
    dev = x.device

    def flag(v: bool) -> torch.Tensor:
        return torch.tensor(v, device=dev)

    first, last = flag(stage == 0), flag(stage == nstages - 1)
    buf = torch.zeros_like(mbs[0])
    outs = [torch.zeros_like(mbs[0]) for _ in range(microbatches)]
    for t in range(t_total):
        # stage 0 ingests microbatch t while t < M; later stages take the
        # handed-over activation
        inp = torch.where(first, mbs[min(t, microbatches - 1)], buf)
        out = stage_fn(params_local, inp)
        # the last stage emits microbatch t-(S-1) when it is valid
        w = min(max(t - (nstages - 1), 0), microbatches - 1)
        outs[w] = torch.where(flag(t >= nstages - 1) & last, out, outs[w])
        if t + 1 < t_total:  # the last tick's hand-over is never read
            buf = _Shift.apply(out, mesh, axis)
    # only the last stage holds real outputs; the sum broadcasts them
    masked = torch.stack(outs) * last.to(outs[0].dtype)
    return _Psum.apply(masked, mesh, axis).reshape(tuple(x.shape))


def bubble_fraction(num_stages: int, microbatches: int) -> float:
    """GPipe idle fraction: (S-1)/(M+S-1)."""
    return (num_stages - 1) / (microbatches + num_stages - 1)
