"""Decoder-only LM stack: dense / SWA / MoE / SSM / hybrid units (port).

Port of ``repro.models.transformer``.  The JAX package scans a stack of
``[U, ...]`` unit parameters; the port keeps ``params['units']`` as a
list of U unit dicts (same inner keys, ``layer_i``) and loops over it in
Python.  A layer's mixer is attention (``attn``/``swa``) or the Mamba-2
SSD block (``ssm``), its FFN a dense SwiGLU or the MoE experts
(``cfg.moe_pattern``), so the jamba hybrid and mixtral are these units
under other patterns; qwen2-vl's attention takes M-RoPE, and its stub
vision embeddings are summed into the prompt's first rows
(:func:`embed_tokens`).  Every projection routes through
``core.linear.apply`` on ``cfg.sparsity``.

The paged cache holds, per attention layer, a page pool shared by every
sequence and, per SSM layer, O(1) recurrent state for each of the
engine's ``max_batch`` slots; both are updated in place.

Training (:func:`lm_loss`) runs the same units with autograd on:
``backbone`` checkpoints each unit under ``cfg.remat`` and, with
``cfg.remat_2level``, each segment of s2 units as well (JAX's two-level
remat scan), and :func:`chunked_xent` computes the LM head and the loss
one checkpointed sequence chunk at a time.  The serving entry points
below keep ``torch.no_grad``.

Under a tensor-parallel context (``sharding.tp``; the sharded train step
of ``runtime.steps`` activates one over the mesh's ``model`` axis) a
training step computes this rank's share: its heads, its F-slice, its
vocab slice of the LM head, with the autograd collectives of ``tp``.
The cross entropy is then vocab-parallel (:func:`_vocab_lse`,
:func:`_vocab_pick`), and with ``cfg.sequence_parallel`` the residual
stream between the collectives is split along S (Megatron-SP, JAX's
``_sp``; :func:`lm_loss`).  Where t does not divide the vocabulary the
head splits the tokens instead (:func:`_token_block`): each rank takes
the whole-vocabulary logits of its 1/t block of the sequence.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import linear as sl
from repro_torch.sharding import tp
from . import attention, layers, moe, ssm


def attn_spec(cfg: ModelConfig, kind: str) -> attention.AttnSpec:
    """Attention spec; under an active tensor-parallel context it
    describes the local shard: heads and KV heads divided by the TP degree
    (head-parallel attention and KV pool), head_dim and the GQA ratio
    kept."""
    shards = tp.size()
    return attention.AttnSpec(
        d_model=cfg.d_model, num_heads=cfg.num_heads // shards,
        num_kv_heads=cfg.num_kv_heads // shards,
        head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta, causal=True,
        sliding_window=cfg.sliding_window if kind == "swa" else None,
        m_rope=cfg.m_rope, tile_skip=cfg.swa_tile_skip)


def ssm_spec(cfg: ModelConfig) -> ssm.SSMSpec:
    """SSM spec; under tensor parallelism the SSD heads shard over the
    ranks (``shards``), d_inner and the heads shrinking to the local
    shard."""
    return ssm.SSMSpec(d_model=cfg.d_model, d_state=cfg.ssm_state,
                       d_conv=cfg.ssm_conv, expand=cfg.ssm_expand,
                       head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk,
                       shards=tp.size())


def moe_spec(cfg: ModelConfig) -> moe.MoESpec:
    """MoE spec: d_ff stays whole; under tensor parallelism the expert
    stacks arrive sliced on F and the block reads F from their shapes."""
    return moe.MoESpec(d_model=cfg.d_model, d_ff=cfg.d_ff,
                       num_experts=cfg.moe_num_experts, top_k=cfg.moe_top_k,
                       capacity_factor=cfg.moe_capacity_factor,
                       expert_padding=cfg.moe_expert_padding)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _remat_split(u: int) -> tuple[int, int]:
    """Factor u = s1 * s2 with s1 + s2 minimal (2-level remat segments)."""
    best = (1, u)
    d = 1
    while d * d <= u:
        if u % d == 0 and d + u // d < sum(best):
            best = (d, u // d)
        d += 1
    return best


def remat(fn, *args):
    """``fn(*args)``, rematerialized in the backward when autograd records
    (``torch.utils.checkpoint``, non-reentrant, so checkpoints nest); a
    plain call otherwise.  Recomputing changes no value."""
    if not torch.is_grad_enabled():
        return fn(*args)
    # the recompute runs in the backward, maybe on autograd's device
    # thread: it runs under this forward's tensor-parallel context
    return checkpoint(tp.bind(fn), *args, use_reentrant=False,
                      preserve_rng_state=False)


def _layers(cfg: ModelConfig):
    """(unit index, layer key, kind, is_moe) in execution order."""
    for u in range(cfg.num_units):
        for i, (kind, is_moe) in enumerate(zip(cfg.unit_pattern,
                                               cfg.moe_pattern)):
            yield u, f"layer_{i}", kind, is_moe


# ------------------------------------------------------------------ init
def init(cfg: ModelConfig, gen: torch.Generator) -> dict[str, Any]:
    """Random weights from ``gen`` on its device, with the JAX
    distributions: linears N(0, 1) * k^-0.5, embedding 0.02 * N(0, 1),
    the SSM block's and MoE experts' own (``ssm.init``, ``moe.init``)."""
    dt, dev = _dtype(cfg), gen.device
    units = []
    for _ in range(cfg.num_units):
        unit = {}
        for i, (kind, is_moe) in enumerate(zip(cfg.unit_pattern,
                                               cfg.moe_pattern)):
            lp = {"pre_norm": layers.rmsnorm_init(cfg.d_model, dev),
                  "mixer": (ssm.init(gen, ssm_spec(cfg), dt) if kind == "ssm"
                            else attention.init(gen, attn_spec(cfg, kind),
                                                dt))}
            if cfg.d_ff > 0:
                lp["ffn_norm"] = layers.rmsnorm_init(cfg.d_model, dev)
                lp["ffn"] = (moe.init(gen, moe_spec(cfg), dt) if is_moe
                             else layers.swiglu_init(gen, cfg.d_model,
                                                     cfg.d_ff, dt))
            unit[f"layer_{i}"] = lp
        units.append(unit)
    return {"embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
            "units": units,
            "final_norm": layers.rmsnorm_init(cfg.d_model, dev),
            "lm_head": sl.init(gen, cfg.d_model, cfg.vocab_size, dt)}


def draw_ssm_wo(params, cfg: ModelConfig, gen: torch.Generator):
    """Draw every SSM block's ``wo`` from N(0, 1) * d_inner^-0.5 with
    ``gen``, in place, and return ``params``.  ``init`` keeps JAX's zero
    ``wo``, which makes a Mamba-2 block the identity; a random-weight
    model meant to run its SSM path draws it here."""
    scale = ssm_spec(cfg).d_inner ** -0.5
    for u, key, kind, _ in _layers(cfg):
        if kind == "ssm":
            wo = params["units"][u][key]["mixer"]["wo"]
            wo["w"] = (torch.randn(wo["w"].shape, generator=gen,
                                   device=gen.device)
                       * scale).to(wo["w"].dtype)
    return params


def _norm(p, x, eps):
    """RMSNorm of the residual stream; under sequence parallelism each
    rank normalizes its S-shard, so its weight's gradient is summed over
    the ranks (``tp.copy_in``)."""
    if tp.sp():
        p = {"g": tp.copy_in(p["g"])}
    return layers.rmsnorm(p, x, eps)


def _ffn(lp, cfg: ModelConfig, xx, is_moe: bool):
    if cfg.d_ff > 0:
        h = _norm(lp["ffn_norm"], xx, cfg.norm_eps)
        xx = xx + (moe.apply(lp["ffn"], moe_spec(cfg), h, cfg.sparsity)
                   if is_moe else layers.swiglu(lp["ffn"], h, cfg.sparsity))
    return xx


def logits_fn(params, cfg: ModelConfig, hidden):
    return layers.unembed(params["lm_head"], hidden, cfg.sparsity)


def _embed(params, cfg, tokens):
    return layers.embed(params["embed"], tokens).to(_dtype(cfg))


def embed_tokens(params, cfg: ModelConfig, tokens, extra_embeds=None):
    """Token ids [B, S] (+ the modality frontend stub's precomputed
    embeddings [B, n, D], summed into the first n positions) -> [B, S, D]."""
    x = _embed(params, cfg, tokens)
    if extra_embeds is not None:
        x[:, :extra_embeds.shape[1]] += extra_embeds.to(x.dtype)
    return x


# -------------------------------------------------------------- training
def _unit(cfg: ModelConfig, unit_params, x, positions):
    """One unit (``len(unit_pattern)`` layers) over a whole sequence, no
    cache: JAX's ``_apply_unit`` in training."""
    sp = cfg.sparsity
    for i, (kind, is_moe) in enumerate(zip(cfg.unit_pattern,
                                           cfg.moe_pattern)):
        lp = unit_params[f"layer_{i}"]
        h = _norm(lp["pre_norm"], x, cfg.norm_eps)
        if kind == "ssm":
            y, _ = ssm.apply(lp["mixer"], ssm_spec(cfg), h, sp)
        else:
            y, _ = attention.apply(lp["mixer"], attn_spec(cfg, kind), h,
                                   positions, sp)
        x = _ffn(lp, cfg, x + y, is_moe)
    return x


def backbone(params, cfg: ModelConfig, x, positions):
    """Embedded inputs [B, S, D] -> final hidden [B, S, D] (no cache).

    With ``cfg.remat`` each unit is checkpointed; with ``remat_2level``
    the U units run as s1 segments of s2 (:func:`_remat_split`), each
    segment checkpointed too, so the backward keeps ~s1 + s2 residual
    carries instead of U (JAX's two-level remat scan)."""
    units = params["units"]

    def run(xx, segment):
        for up in segment:
            xx = (remat(_unit, cfg, up, xx, positions) if cfg.remat
                  else _unit(cfg, up, xx, positions))
        return xx

    s1, s2 = (_remat_split(cfg.num_units)
              if cfg.remat and cfg.remat_2level else (1, cfg.num_units))
    if s1 == 1:
        x = run(x, units)
    else:
        for i in range(s1):
            x = remat(run, x, units[i * s2:(i + 1) * s2])
    return _norm(params["final_norm"], x, cfg.norm_eps)


def _vocab_lse(logits):
    """logsumexp over the vocabulary of this rank's logits [..., V/t]
    (its vocab slice under tensor parallelism): the row maxima, the sums
    of exponentials and so the result taken over every rank's slice."""
    if tp.size() == 1:
        return torch.logsumexp(logits, dim=-1)
    m = tp.reduce_max(logits.detach().amax(-1))
    return torch.log(tp.total(torch.exp(logits - m[..., None]).sum(-1))) + m


def _vocab_pick(logits, labels):
    """Each row's logit at its label (0 for a label < 0) from this rank's
    vocab slice: under tensor parallelism only the rank whose slice holds
    the label adds it to the sum over the ranks."""
    lab = torch.clamp_min(labels, 0).long()
    if tp.size() == 1:
        return torch.gather(logits, -1, lab[..., None])[..., 0]
    vloc = logits.shape[-1]
    lo = tp.rank() * vloc
    own = (lab >= lo) & (lab < lo + vloc)
    got = torch.gather(logits, -1,
                       torch.clamp(lab - lo, 0, vloc - 1)[..., None])[..., 0]
    return tp.total(torch.where(own, got, torch.zeros((), dtype=got.dtype,
                                                      device=got.device)))


def _chunk_loss(lm_head, cfg: ModelConfig, hc, lc, vocab_split=True):
    """(summed NLL, valid count) of one sequence chunk; labels < 0 are
    masked out.  ``vocab_split``: the logits are this rank's vocab slice
    under tensor parallelism; else they span the whole vocabulary (the
    token-split head's)."""
    logits = layers.unembed(lm_head, hc, cfg.sparsity).to(torch.float32)
    if vocab_split:
        lse, picked = _vocab_lse(logits), _vocab_pick(logits, lc)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1,
                              torch.clamp_min(lc, 0).long()[..., None])[..., 0]
    valid = (lc >= 0).to(torch.float32)
    return ((lse - picked) * valid).sum(), valid.sum()


def _token_block(lm_head, h, labels):
    """The token-split head's inputs on this rank: the LM head whole, its
    gradient summed over the t ranks (``tp.replicated``); this rank's
    contiguous block of S/t positions of ``h`` and the labels, in the
    order ``tp.split_seq`` gives the ranks.  Under sequence parallelism
    the residual stream is that block already; else ``h`` enters through
    ``tp.copy_in``, so the blocks' gradients sum to its whole one."""
    t, s = tp.size(), labels.shape[1]
    if s % t:
        raise ValueError(
            f"the token-split LM head needs S % t == 0 (S={s}, t={t}): "
            "t does not divide the vocabulary, so each of the t ranks "
            "takes a block of the sequence")
    n = s // t
    labels = labels.narrow(1, tp.rank() * n, n)
    if not tp.sp():
        h = tp.copy_in(h).narrow(1, tp.rank() * n, n)
    return tp.replicated(lm_head), h, labels


def _token_sum(total, count):
    """The token-split head's (NLL sum, label count), summed over the t
    ranks in one all-reduce."""
    both = tp.total(torch.stack([total, count]))
    return both[0], both[1]


def chunked_xent(lm_head, cfg: ModelConfig, h, labels):
    """Sequence-chunked LM head + next-token cross entropy: each chunk's
    [B, chunk, V] logits are recomputed in the backward (checkpointed),
    so no full-sequence fp32 logits are ever held.  Returns the mean NLL
    over labels >= 0, ``total / max(count, 1)``.  Under tensor
    parallelism over t ranks, where t divides the vocabulary, ``h``
    enters the column-parallel LM head once (gathered along S under
    sequence parallelism) and each chunk's loss is vocab-parallel; else
    each rank runs the whole head over its block of the sequence
    (:func:`_token_block`) and the sums are totalled over the ranks."""
    split_tokens = tp.size() > 1 and not tp.vocab_parallel(cfg, tp.size())
    if split_tokens:
        lm_head, h, labels = _token_block(lm_head, h, labels)
    else:
        h = tp.enter(h)
    _, s, _ = h.shape
    chunk = min(cfg.logits_chunk, s)
    pad = (-s) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    total = count = None
    for c in range(0, s + pad, chunk):
        nll, n = remat(_chunk_loss, lm_head, cfg, h[:, c:c + chunk],
                       labels[:, c:c + chunk], not split_tokens)
        total = nll if total is None else total + nll
        count = n if count is None else count + n
    if split_tokens:
        total, count = _token_sum(total, count)
    return total / torch.clamp_min(count, 1.0)


def lm_loss(params, cfg: ModelConfig, tokens, labels, extra_embeds=None):
    """Next-token cross entropy of a batch (tokens, labels [B, S]) with
    the sequence-chunked LM head; gradients flow to every float leaf.

    With ``cfg.sequence_parallel`` under a tensor-parallel context of t
    ranks, and S a multiple of t, the residual stream is split along S
    between the units (JAX's ``_sp``): each rank keeps S/t of it, the
    column-parallel groups gather it and the row-parallel projections
    reduce-scatter it."""
    x = embed_tokens(params, cfg, tokens, extra_embeds)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    on = getattr(cfg, "sequence_parallel", False) and s % tp.size() == 0
    with tp.sequence_parallel(on):
        h = backbone(params, cfg, tp.split_seq(x), positions)
        return chunked_xent(params["lm_head"], cfg, h, labels)


# ------------------------------------------------------------- one-shot
@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int | None = None, extra_embeds=None):
    """Full-prompt forward; returns (logits_last [B, V], cache, kv_len).
    ``extra_embeds``: the vision stub's embeddings (:func:`embed_tokens`)."""
    b, s = tokens.shape
    max_len = max_len or s
    xx = embed_tokens(params, cfg, tokens, extra_embeds)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    sp = cfg.sparsity
    kv = getattr(torch, cfg.kv_cache_dtype)
    cache = [dict() for _ in range(cfg.num_units)]
    for u, key, kind, is_moe in _layers(cfg):
        lp = params["units"][u][key]
        hh = layers.rmsnorm(lp["pre_norm"], xx, cfg.norm_eps)
        if kind == "ssm":
            y, cache[u][key] = ssm.apply(lp["mixer"], ssm_spec(cfg), hh, sp)
        else:
            spec = attn_spec(cfg, kind)
            y, _ = attention.apply(lp["mixer"], spec, hh, positions, sp)
            cache[u][key] = attention.build_prefill_cache(
                lp["mixer"], spec, hh, positions, sp, max_len, kv)
        xx = _ffn(lp, cfg, xx + y, is_moe)
    h = layers.rmsnorm(params["final_norm"], xx, cfg.norm_eps)
    logits = logits_fn(params, cfg, h[:, -1:, :])[:, 0]
    kv_len = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return logits, cache, kv_len


@torch.no_grad()
def serve_step(params, cfg: ModelConfig, token, cache, kv_len):
    """One-token decode over the dense cache (updated in place; an SSM
    layer's entry is replaced by its new state).
    token: [B] int; returns (logits [B, V], cache, kv_len + 1)."""
    xx = _embed(params, cfg, token[:, None])
    positions = kv_len[:, None]
    for u, key, kind, is_moe in _layers(cfg):
        lp = params["units"][u][key]
        hh = layers.rmsnorm(lp["pre_norm"], xx, cfg.norm_eps)
        if kind == "ssm":
            y, cache[u][key] = ssm.apply(lp["mixer"], ssm_spec(cfg), hh,
                                         cfg.sparsity, cache=cache[u][key])
        else:
            y, _ = attention.apply(lp["mixer"], attn_spec(cfg, kind), hh,
                                   positions, cfg.sparsity,
                                   cache=cache[u][key], kv_len=kv_len)
        xx = _ffn(lp, cfg, xx + y, is_moe)
    h = layers.rmsnorm(params["final_norm"], xx, cfg.norm_eps)
    return logits_fn(params, cfg, h)[:, 0], cache, kv_len + 1


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """The one-shot dense cache, per unit: per attention layer a
    [B, max_len, KVH, hd] cache in ``kv_cache_dtype``, per SSM layer the
    recurrent state of each row (``prefill`` builds the same layout)."""
    kv = getattr(torch, cfg.kv_cache_dtype)
    device = resolve_device(device)
    return [{f"layer_{i}": (
        ssm.make_cache(ssm_spec(cfg), batch, device=device) if kind == "ssm"
        else attention.make_cache(attn_spec(cfg, kind), batch, max_len, kv,
                                  device))
        for i, kind in enumerate(cfg.unit_pattern)}
        for _ in range(cfg.num_units)]


# ------------------------------------------------------- paged inference
def make_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     max_batch: int, device=None):
    """Per unit: per attention layer a physical page pool of ``num_pages``
    pages [page_size, KVH, hd] and the spare page that takes dropped
    writes (``attention.make_paged_pool``), one logical page id
    addressing the same slot in every layer; per SSM layer the recurrent
    state of each of ``max_batch`` slots (``ssm.make_cache``).  Under an
    active tensor-parallel context each is the rank's shard: KVH/tp heads
    per page, the SSM state at d_inner/tp and heads/tp."""
    kv = getattr(torch, cfg.kv_cache_dtype)
    device = resolve_device(device)
    def layer(kind):
        if kind == "ssm":
            return ssm.make_cache(ssm_spec(cfg), max_batch, device=device)
        return attention.make_paged_pool(attn_spec(cfg, kind), num_pages,
                                         page_size, kv, device)

    return [{f"layer_{i}": layer(kind)
             for i, kind in enumerate(cfg.unit_pattern)}
            for _ in range(cfg.num_units)]


def _ssm_chunk(lp, cfg, hh, state, slot, reset, real_len):
    """An SSM layer of a prefill chunk: the slot's state (zeroed when
    ``reset``) runs the chunked scan over the chunk's ``real_len`` real
    tokens and is written back to the slot, all at device indices."""
    idx = slot.to(torch.int64).reshape(1)
    st = {k: torch.where(reset, torch.zeros((), dtype=a.dtype,
                                            device=a.device),
                         a.index_select(0, idx))
          for k, a in state.items()}
    vlen = real_len.to(torch.int32).reshape(1).expand(hh.shape[0])
    y, new = ssm.apply(lp["mixer"], ssm_spec(cfg), hh, cfg.sparsity,
                       cache=st, chunked=True, valid_len=vlen)
    for k, a in state.items():
        a.index_copy_(0, idx, new[k].to(a.dtype))
    return y


@torch.no_grad()
def paged_prefill_chunk(params, cfg: ModelConfig, tokens, cache, page_table,
                        start: torch.Tensor, real_len: torch.Tensor,
                        slot: torch.Tensor, reset: torch.Tensor,
                        page_size: int):
    """One prompt chunk of one sequence through the paged cache.
    tokens: [1, C] (rows >= real_len are right-padding); page_table:
    [1, max_pages]; start/real_len/slot: int32 device scalars (0-d) and
    reset a bool device scalar (True on a sequence's first chunk, zeroing
    the slot's stale SSM state), so the step reads no value on the host.
    Returns (logits [1, V] at the last real token, cache)."""
    b, c = tokens.shape
    xx = _embed(params, cfg, tokens)
    positions = start + torch.arange(c, dtype=torch.int32,
                                     device=tokens.device)[None].expand(b, c)
    for u, key, kind, is_moe in _layers(cfg):
        lp = params["units"][u][key]
        hh = layers.rmsnorm(lp["pre_norm"], xx, cfg.norm_eps)
        if kind == "ssm":
            y = _ssm_chunk(lp, cfg, hh, cache[u][key], slot, reset, real_len)
        else:
            y, _ = attention.paged_prefill_chunk(
                lp["mixer"], attn_spec(cfg, kind), hh, positions,
                cfg.sparsity, cache[u][key], page_table, start, real_len,
                page_size)
        xx = _ffn(lp, cfg, xx + y, is_moe)
    h = layers.rmsnorm(params["final_norm"], xx, cfg.norm_eps)
    last = torch.clamp(real_len - 1, 0, c - 1).long().reshape(1)
    return logits_fn(params, cfg, h.index_select(1, last))[:, 0], cache


@torch.no_grad()
def paged_decode_step(params, cfg: ModelConfig, token, cache, page_table,
                      kv_len, active, page_size: int):
    """One decode token for every slot.  token: [B]; kv_len: [B] context
    lengths already written; active: [B] bool.  An inactive slot (one
    mid-chunked-prefill among them) keeps its SSM state bit for bit.
    Returns (logits [B, V], cache)."""
    b = token.shape[0]
    xx = _embed(params, cfg, token[:, None])
    for u, key, kind, is_moe in _layers(cfg):
        lp = params["units"][u][key]
        hh = layers.rmsnorm(lp["pre_norm"], xx, cfg.norm_eps)
        if kind == "ssm":
            state = cache[u][key]
            y, new = ssm.apply(lp["mixer"], ssm_spec(cfg), hh, cfg.sparsity,
                               cache=state)
            for k, a in state.items():
                on = active.reshape((b,) + (1,) * (a.dim() - 1))
                a.copy_(torch.where(on, new[k].to(a.dtype), a))
        else:
            y, _ = attention.paged_decode_step(
                lp["mixer"], attn_spec(cfg, kind), hh, cfg.sparsity,
                cache[u][key], page_table, kv_len, active, page_size)
        xx = _ffn(lp, cfg, xx + y, is_moe)
    h = layers.rmsnorm(params["final_norm"], xx, cfg.norm_eps)
    return logits_fn(params, cfg, h)[:, 0], cache


@torch.no_grad()
def paged_verify_step(params, cfg: ModelConfig, tokens, cache, page_table,
                      kv_len, real_len, active, page_size: int):
    """Speculative verify: score C = K + 1 tokens per slot in one pass.
    tokens: [B, C], per slot the last emitted token and its drafts,
    right-padded; kv_len: [B] context lengths already written (the decode
    convention); real_len: [B] real lanes (1 + drafts); active: [B] bool.
    Returns (logits [B, C, V], cache): logits[:, i] predicts the token
    after lane i, and the host accepts the longest agreeing prefix.  SSM
    stacks raise: their state cannot roll back a rejected suffix (the
    engine refuses them at construction)."""
    if cfg.uses_ssm:
        raise ValueError("speculative verify_step does not support SSM "
                         "layers (recurrent state cannot roll back rejected "
                         "drafts)")
    xx = _embed(params, cfg, tokens)
    for u, key, kind, is_moe in _layers(cfg):
        lp = params["units"][u][key]
        hh = layers.rmsnorm(lp["pre_norm"], xx, cfg.norm_eps)
        y, _ = attention.paged_verify_step(
            lp["mixer"], attn_spec(cfg, kind), hh, cfg.sparsity,
            cache[u][key], page_table, kv_len, real_len, active, page_size)
        xx = _ffn(lp, cfg, xx + y, is_moe)
    h = layers.rmsnorm(params["final_norm"], xx, cfg.norm_eps)
    return logits_fn(params, cfg, h), cache


@torch.no_grad()
def paged_copy_pages(cfg: ModelConfig, cache, src_ids, dst_ids):
    """Copy-on-write step: copy pages ``src_ids[i] -> dst_ids[i]`` in
    every attention layer's pool, in place (one logical page id addresses
    the same slot in every layer, so one host decision copies the whole
    stack).  A dst naming the spare page is a padding lane.  SSM layers
    hold per-slot state, not pages, and pass through untouched."""
    for u, key, kind, _ in _layers(cfg):
        if kind != "ssm":
            attention.pool_copy_pages(cache[u][key], src_ids, dst_ids)
    return cache
