"""AdamW with optional blockwise-int8 moments (port of
``repro.optim.adamw``).

The functional API of the JAX package (``init``, ``update`` returning
``(params, state, metrics)``) over the port's parameter trees; ``update``
writes the parameters and the moments in place, under ``torch.no_grad``,
and returns them, so a step holds one copy of the optimizer state.  The
int8 state keeps each moment in its parameter's shape with fp32 scales
per block of the last dim (2 bytes a parameter of moments instead of 8);
the second moment is stored as sqrt(nu), and the normalized update of an
int8 step is clamped to [-10, 10] (8-bit-Adam's trust clamp).

Given a ``rules.Layout``, ``update`` runs on one rank's pieces: the
global norm counts each element once (a piece replicated over some axes
adds its sum of squares on one of its replicas only), and an int8 block
that spans the ranks of a sharded last dim (its scale replicated, as
``rules.opt_state_shardings`` leaves it when the block count does not
divide the axis) takes its absmax over those ranks, so the pieces
quantize as the whole tensor would.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import torch

from repro_torch import tree
from repro_torch.sharding import rules


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # 'float32' | 'int8' (blockwise compressed)
    block: int = 256


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the parameters' device
    mu: Any
    nu: Any
    mu_scale: Any  # None unless int8 state
    nu_scale: Any


# ---------------------------------------------------------- int8 moments
def block_for(last_dim: int, target: int) -> int:
    """The largest divisor of ``last_dim`` not above ``target``."""
    for b in range(min(target, last_dim), 0, -1):
        if last_dim % b == 0:
            return b
    return 1


def _blockwise_quant(x: torch.Tensor, block_target: int):
    """fp32 x -> (int8 q in x's shape, fp32 scales [..., last / block]):
    symmetric, scale = max(absmax, 1e-12) / 127 per block, round half to
    even."""
    last = x.shape[-1]
    blk = block_for(last, block_target)
    blocks = x.reshape(tuple(x.shape[:-1]) + (last // blk, blk))
    scale = torch.clamp_min(blocks.abs().amax(dim=-1), 1e-12) / 127.0
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    return q.reshape(x.shape).to(torch.int8), scale.to(torch.float32)


def _blockwise_dequant(q: torch.Tensor, scale: torch.Tensor,
                       block_target: int) -> torch.Tensor:
    last = q.shape[-1]
    blk = block_for(last, block_target)
    blocks = q.reshape(tuple(q.shape[:-1]) + (last // blk, blk)).to(
        torch.float32)
    return (blocks * scale[..., None]).reshape(q.shape)


class _Spanning:
    """A piece whose sharded last dim cuts through int8 blocks: the block
    of each of its columns, and the axes the last dim is sharded over."""

    def __init__(self, p, spec, layout, block_target):
        mesh = layout.mesh
        self.mesh, self.axes = mesh, rules.axes_of(spec[p.dim() - 1])
        whole = rules.global_shape(p.shape, spec, mesh)[-1]
        blk = block_for(whole, block_target)
        start = rules.offset(spec, p.dim() - 1, whole, mesh)
        self.nblocks = whole // blk
        self.block = (start + torch.arange(p.shape[-1], device=p.device)) \
            // blk

    def quant(self, x):
        idx = self.block.expand(x.shape)
        absmax = torch.zeros(tuple(x.shape[:-1]) + (self.nblocks,),
                             dtype=torch.float32, device=x.device)
        absmax = absmax.scatter_reduce(-1, idx, x.abs(), "amax")
        absmax = self.mesh.all_reduce(absmax, self.axes, "max")
        scale = torch.clamp_min(absmax, 1e-12) / 127.0
        q = torch.clamp(torch.round(x / scale[..., self.block]), -127, 127)
        return q.to(torch.int8), scale

    def dequant(self, q, scale):
        return q.to(torch.float32) * scale[..., self.block]


def _spanning(p, spec, scale_spec, layout, block_target):
    """A ``_Spanning`` where the piece's last dim is sharded and its
    scales are not, else None."""
    if layout is None or p.dim() == 0 or len(spec) < p.dim():
        return None
    if spec[p.dim() - 1] is None or scale_spec[p.dim() - 1] is not None:
        return None
    return _Spanning(p, spec, layout, block_target)


def init(params, cfg: AdamWConfig) -> OptState:
    """Zero moments (fp32, or int8 with zero scales) and step 0, on the
    parameters' device."""
    device = tree.leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.state_dtype == "int8":
        def zq(p):
            return torch.zeros(p.shape, dtype=torch.int8, device=p.device)

        def zs(p):
            last = p.shape[-1] if p.dim() else 1
            return torch.zeros(tuple(p.shape[:-1])
                               + (last // block_for(last, cfg.block),),
                               dtype=torch.float32, device=p.device)

        return OptState(step, tree.tree_map(zq, params),
                        tree.tree_map(zq, params), tree.tree_map(zs, params),
                        tree.tree_map(zs, params))

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(step, tree.tree_map(zeros, params),
                    tree.tree_map(zeros, params), None, None)


def global_norm(grads, layout=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (the per-leaf
    norms' norm: the same quantity as JAX's sum, in another order).
    Given a layout, of the whole leaves whose pieces ``grads`` holds."""
    if layout is None:
        norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
                 for g in tree.leaves(grads)]
        return torch.linalg.vector_norm(torch.stack(norms))
    mesh = layout.mesh
    sq = []
    for g, spec in zip(tree.leaves(grads), layout.params):
        sharded = {a for d in spec for a in rules.axes_of(d)}
        # one replica of each piece counts: the rank at coordinate 0 of
        # every axis the piece is replicated over
        if all(mesh.coord(a) == 0 for a in mesh.axis_names
               if a not in sharded):
            sq.append(torch.sum(torch.square(g.to(torch.float32))))
    total = torch.stack(sq).sum() if sq else torch.zeros(
        (), dtype=torch.float32, device=mesh.device)
    return torch.sqrt(mesh.all_reduce(total, mesh.axis_names, "sum"))


@torch.no_grad()
def update(params, grads, state: OptState, cfg: AdamWConfig, lr_scale=1.0,
           layout=None):
    """One AdamW step with global-norm clipping.  Writes ``params`` and
    the state's moments in place; returns (params, new_state, metrics)
    with metrics {'grad_norm' (before clipping), 'lr'}.  Given a
    ``rules.Layout``, ``params``, ``grads`` and ``state`` are one rank's
    pieces (the module docstring)."""
    step = state.step + 1
    gnorm = global_norm(grads, layout)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12), 1.0)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)
    lr = cfg.lr * lr_scale
    int8_state = cfg.state_dtype == "int8"
    none = [None] * len(tree.leaves(params))

    specs = none if layout is None else layout.params
    scale_specs = layout.scales if int8_state and layout else none

    for p, g, mu, nu, mus, nus, spec, sspec in zip(
            tree.leaves(params), tree.leaves(grads), tree.leaves(state.mu),
            tree.leaves(state.nu),
            tree.leaves(state.mu_scale) if int8_state else none,
            tree.leaves(state.nu_scale) if int8_state else none,
            specs, scale_specs):
        g = g.to(torch.float32) * clip
        span = _spanning(p, spec, sspec, layout, cfg.block) \
            if int8_state else None
        if span is not None:
            m = span.dequant(mu, mus)
            v = span.dequant(nu, nus) ** 2
        elif int8_state:
            m = _blockwise_dequant(mu, mus, cfg.block)
            v = _blockwise_dequant(nu, nus, cfg.block) ** 2  # stored sqrt
        else:
            m, v = mu, nu
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if int8_state:
            # quantized nu can round small entries to zero: bound the
            # normalized update so mu / (0 + eps) cannot explode
            upd = torch.clamp(upd, -10.0, 10.0)
        upd = upd + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * upd).to(p.dtype))
        if int8_state:
            quant = span.quant if span is not None else functools.partial(
                _blockwise_quant, block_target=cfg.block)
            q, s = quant(m)
            mu.copy_(q)
            mus.copy_(s)
            # sqrt(nu) halves the dynamic range, so small second moments
            # survive symmetric int8
            q, s = quant(torch.sqrt(v))
            nu.copy_(q)
            nus.copy_(s)
        else:
            mu.copy_(m)
            nu.copy_(v)
    new_state = OptState(step, state.mu, state.nu, state.mu_scale,
                         state.nu_scale)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
