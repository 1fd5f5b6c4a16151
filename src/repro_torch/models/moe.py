"""Mixture-of-Experts FFN: top-k routing with capacity, scatter dispatch
(port of ``repro.models.moe``).

Tokens are grouped ``[G, Tg]``; within a group every (token, k) slot
takes a position in its expert's queue in (t, k)-major order (earlier
tokens win capacity), and a slot past ``cap`` is dropped.  The slot ->
token map is built by integer segment sums, as JAX builds it, the tokens
are gathered into ``[G, Ep, C, D]`` capacity buffers, and the three
expert products are batched matmuls (``torch.bmm``) over the stacked
``[Ep, out, in]`` weights in the activation dtype (the JAX package runs them as einsums,
outside any Pallas kernel).

Two choices keep a step bit-reproducible on the card, which the engine's
graphed == eager and slided == compressed gates need:
- routing ties break by the lower expert index, as ``jax.lax.top_k``
  does: a stable descending sort, not ``torch.topk`` (whose tie order is
  unspecified);
- the combine sums each token's k gate-weighted slot outputs in
  ascending slot index (XLA's scatter-add order), gathered through the
  inverse map; float ``index_add_`` would add in an unfixed atomic order.
Nothing here reads a device value on the host (no ``nonzero``, boolean
indexing or ``.item()``), so a step that runs it is CUDA-graph capturable.

For serving, the expert stacks are pruned to the pattern once, at load
(``serve_loop.pack_params`` stores ``{"pruned": ...}``); JAX prunes them
on every call, and pruning is idempotent, so the values are the same.
In ``mode="masked"`` (training) each stack is STE-pruned on every call
from its live weights (``masks.ste_prune``), never read from that cache,
which an optimizer step would leave stale.  ``aux_load_balance_loss`` is
ported as a function; JAX's ``loss_fn`` adds it to no loss, nor does the
port's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import masks, packer
from repro_torch.core.linear import SparsityConfig
from repro_torch.sharding import tp


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 256  # tokens per dispatch group
    expert_padding: int = 0  # stack padded to this (>= num_experts); 0 = off

    @property
    def num_stacked(self) -> int:
        return max(self.num_experts, self.expert_padding)


def init(gen: torch.Generator, spec: MoESpec, dtype=torch.float32):
    """Router N(0, 1) * d^-0.5 in fp32 over the real experts; expert
    stacks [Ep, out, in] N(0, 1) * in^-0.5, drawn in fp32 then cast."""
    e, d, f = spec.num_stacked, spec.d_model, spec.d_ff
    dev = gen.device

    def stack(kin, kout):
        w = torch.randn((e, kout, kin), generator=gen, dtype=torch.float32,
                        device=dev) * kin ** -0.5
        return {"w": w.to(dtype)}

    router = torch.randn((spec.num_experts, d), generator=gen,
                         dtype=torch.float32, device=dev) * d ** -0.5
    return {"router": {"w": router},
            "w_gate": stack(d, f), "w_up": stack(d, f),
            "w_down": stack(f, d)}


def prune_stacks(params, sp_cfg: SparsityConfig):
    """Load-time form of the block: each expert stack pruned to the
    pattern along its contraction dim (``{"pruned": w}``), as JAX's
    ``_expert_weights`` prunes it on every call; the router stays."""
    dec = sp_cfg.decomposition()
    if dec is None or sp_cfg.mode not in ("slided", "compressed"):
        return params
    out = dict(params)
    for name in ("w_gate", "w_up", "w_down"):
        p = params[name]
        if "pruned" not in p:
            out[name] = {"pruned": packer.prune_to_pattern(p["w"],
                                                           dec.source)}
    return out


def _expert_weights(p, sp_cfg: SparsityConfig) -> torch.Tensor:
    """Stacked [Ep, M, K] expert weights under the configured sparsity."""
    dec = sp_cfg.decomposition()
    if dec is not None and sp_cfg.mode == "masked":
        return masks.ste_prune(p["w"], dec.source)
    if "pruned" in p:
        return p["pruned"]
    if dec is not None and sp_cfg.mode in ("slided", "compressed"):
        return packer.prune_to_pattern(p["w"], dec.source)
    return p["w"]


def _top_k(logits: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply(params, spec: MoESpec, x: torch.Tensor,
          sp_cfg: SparsityConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D].  Under tensor parallelism the expert
    stacks are this rank's F-slice: x enters through ``tp.enter``, the
    router's weight through ``tp.replicated`` (its gates scale this
    rank's partial outputs only), and the combined output is summed over
    the ranks."""
    x = tp.enter(x)
    b, s, d = x.shape
    t = b * s
    tg = min(spec.group_size, t)
    g = t // tg
    assert g * tg == t, f"tokens {t} not divisible by group size {tg}"
    e, k, ep = spec.num_experts, spec.top_k, spec.num_stacked
    cap = max(1, int(spec.capacity_factor * tg * k / e))
    dt, dev = x.dtype, x.device
    xg = x.reshape(g, tg, d)

    # router dot in the activation dtype; only the [G, Tg, E] logits go f32
    router = tp.replicated(params["router"])["w"]
    logits = (xg @ router.to(dt).T).to(torch.float32)
    top_vals, top_idx = _top_k(logits, k)                  # [G, Tg, K]
    gates = torch.softmax(top_vals, dim=-1)

    # position of every (token, slot) in its expert queue, (t, k)-major
    flat = (top_idx[..., None] == torch.arange(e, device=dev)).to(
        torch.int32).reshape(g, tg * k, e)
    pos_all = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    pos = (pos_all * flat).sum(-1).reshape(g, tg, k)
    keep = pos < cap                                       # capacity drop
    # destination row in the [Ep*C] expert buffer; past it, the overflow
    # bucket (JAX's is e*cap, the same row when the stack is unpadded)
    nslot = ep * cap + 1
    dest = torch.where(keep, top_idx * cap + pos, ep * cap)   # [G, Tg, K]

    # slot -> token map: each capacity slot holds at most one token, so
    # segment sums of the token id / gate / a count recover it exactly
    dflat = dest.reshape(g, tg * k)
    tok_ids = torch.arange(tg, dtype=torch.int64, device=dev)[:, None] \
        .expand(tg, k).reshape(1, tg * k).expand(g, tg * k)
    src = torch.zeros((g, nslot), dtype=torch.int64, device=dev) \
        .scatter_add_(1, dflat, tok_ids)[:, :ep * cap]
    filled = torch.zeros((g, nslot), dtype=torch.int32, device=dev) \
        .scatter_add_(1, dflat, torch.ones_like(dflat, dtype=torch.int32))
    live = filled[:, :ep * cap] > 0
    # one contributor per live slot: the float sum is that gate, exactly
    slot_gate = torch.zeros((g, nslot), dtype=torch.float32, device=dev) \
        .scatter_add_(1, dflat, gates.reshape(g, tg * k))[:, :ep * cap]

    # dispatch: gather tokens into the capacity buffers
    xin = torch.gather(xg, 1, src[..., None].expand(g, ep * cap, d))
    xin = torch.where(live[..., None], xin, torch.zeros((), dtype=dt,
                                                        device=dev))
    # the [G, Ep, C, D] buffers, expert-major for one batched matmul per
    # product over the [Ep, out, in] stacks (no broadcast copy of weights)
    xin = xin.reshape(g, ep, cap, d).transpose(0, 1).reshape(ep, g * cap, d)

    w_gate = _expert_weights(params["w_gate"], sp_cfg).to(dt)
    w_up = _expert_weights(params["w_up"], sp_cfg).to(dt)
    w_down = _expert_weights(params["w_down"], sp_cfg).to(dt)
    hg = torch.bmm(xin, w_gate.transpose(1, 2))            # [Ep, G*C, F]
    h = hg * torch.sigmoid(hg) * torch.bmm(xin, w_up.transpose(1, 2))
    out = torch.bmm(h, w_down.transpose(1, 2))             # [Ep, G*C, D]
    out = out.reshape(ep, g, cap, d).transpose(0, 1)       # [G, Ep, C, D]

    # combine: gate-weighted slot outputs summed into their source token
    # in ascending slot index; the overflow row reads zeros
    upd = out.reshape(g, ep * cap, d) * slot_gate[..., None].to(dt)
    upd = torch.cat([upd, torch.zeros((g, 1, d), dtype=dt, device=dev)], 1)
    order = torch.sort(dest, dim=-1).values.reshape(g, tg * k)
    picked = torch.gather(upd, 1, order[..., None].expand(g, tg * k, d))
    picked = picked.reshape(g, tg, k, d)
    y = torch.zeros((g, tg, d), dtype=dt, device=dev)
    for j in range(k):
        y = y + picked[:, :, j]
    # tensor parallelism: the expert hidden F is sharded, so each rank's
    # y is a partial sum; routing, gates and the combine are the same on
    # every rank (the router is replicated), so the one all-reduce rides
    # the combined output, in fp32 as ``linear.apply`` sums its partials
    y = y.reshape(b, s, d)
    return tp.reduce(y.to(torch.float32)).to(dt) if tp.size() > 1 else y


def aux_load_balance_loss(logits: torch.Tensor, top_idx: torch.Tensor,
                          num_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss over router logits
    [G, Tg, E] and the top-k expert ids [G, Tg, K]: E times the dot of
    each expert's share of first choices and its mean router
    probability."""
    probs = torch.softmax(logits, dim=-1)
    first = torch.nn.functional.one_hot(top_idx[..., 0].long(), num_experts)
    density = first.to(torch.float32).mean(dim=(0, 1))
    density_proxy = probs.mean(dim=(0, 1))
    return num_experts * torch.sum(density * density_proxy)
