"""Attention: GQA with RoPE/M-RoPE and sliding windows, one-shot and paged.

Port of ``repro.models.attention``.  The one-shot path (prefill, the
dense-cache decode of ``generate`` and the encoder-decoder's
cross-attention) is the chunked flash-style SDPA in plain torch; the
paged path writes K/V into a shared page pool and attends through
``pool_attend``, which dispatches to the paged-attention kernel
(``sp_cfg.fused_attention``) or to the gather-then-SDPA oracle.

Where JAX silently clamps or drops, torch raises, so the table reads clamp
explicitly and the dropped writes land in a spare page that no page table
names (:func:`make_paged_pool`).  The pool is updated IN PLACE (the JAX
version returns a new pool): the engine holds one pool per layer and
never needs the old one, and in-place writes save a pool copy per step.
Nothing on the paged path reads a device value on the host, so a step is
one stream of launches that a CUDA graph can capture.

The one-shot decode also runs over a cache split along S across a mesh
of ranks (the sequence-sharded serve step, ``sharding.seq``): each rank
attends over its slice and the ranks' softmax partials are combined.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core import linear as sl, quant
from repro_torch.core.linear import SparsityConfig
from repro_torch.sharding import seq, tp
from . import layers

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 1e4
    causal: bool = True
    sliding_window: int | None = None  # None -> full/global attention
    m_rope: bool = False
    q_chunk: int = 1024
    kv_chunk: int = 1024
    tile_skip: bool = False  # windowed layers scan only their KV chunks

    @property
    def q_dim(self):
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self):
        return self.num_kv_heads * self.head_dim


def init(gen: torch.Generator, spec: AttnSpec, dtype=torch.float32):
    return {"wq": sl.init(gen, spec.d_model, spec.q_dim, dtype),
            "wk": sl.init(gen, spec.d_model, spec.kv_dim, dtype),
            "wv": sl.init(gen, spec.d_model, spec.kv_dim, dtype),
            "wo": sl.init(gen, spec.q_dim, spec.d_model, dtype)}


def _split_heads(x, n, hd):
    return x.reshape(tuple(x.shape[:-1]) + (n, hd))


def _rope(spec: AttnSpec, x, positions):
    if positions is None:
        return x
    if spec.m_rope:
        if positions.dim() == 2:  # text only: the three streams are equal
            positions = positions[None].expand((3,) + tuple(positions.shape))
        return layers.apply_mrope(x, positions, spec.rope_theta)
    return layers.apply_rope(x, positions, spec.rope_theta)


def _einsum(eq, a, b):
    """einsum with JAX's type promotion (an f32 query against a bf16 cache
    computes in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _mask_tile(spec: AttnSpec, q_pos, k_pos):
    """[q, k] additive mask tile from absolute positions."""
    d = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if spec.causal:
        ok &= d >= 0
    if spec.sliding_window is not None:
        ok &= d < spec.sliding_window
    return torch.where(ok, 0.0, NEG_INF)


def _kv_window(spec: AttnSpec, q_offset, qi: int, cq: int, ck: int,
               nk: int):
    """The KV chunks query chunk ``qi`` visits: ``n`` chunks from
    ``first`` on, all ``nk`` from 0 but under ``spec.tile_skip`` in a
    causal sliding-window layer.  There the ``n`` chunks hold every key
    the chunk's rows see, from the first row's absolute position
    (``q_offset + qi * cq``) less the window, clamped into the ``nk``.
    JAX's slice starts from ``qi * cq`` and drops ``q_offset``, which is
    right only at offset 0.  ``first`` is an int, or an int device
    tensor where ``q_offset`` is one."""
    w = spec.sliding_window
    if not (spec.tile_skip and spec.causal and w is not None):
        return 0, nk
    n = min(nk, (w + cq + ck - 1) // ck + 1)
    start = (q_offset + qi * cq - w + 1) // ck
    if isinstance(start, torch.Tensor):
        return torch.clamp(start, 0, nk - n), n
    return min(max(start, 0), nk - n), n


def _chunked_sdpa(spec: AttnSpec, q, k, v, q_offset=0):
    """q: [B, Sq, H, hd]; k/v: [B, Sk, KVH, hd] -> [B, Sq, H, hd].
    Two-level loop (query chunks, then KV chunks) with running
    (max, denom, acc): the FlashAttention dataflow in plain torch.
    ``q_offset``: an int, or an int32 device scalar (a prefill chunk's
    start).  Under ``spec.tile_skip`` a sliding-window layer visits only
    the KV chunks of :func:`_kv_window`, sliced (a device offset's by an
    ``index_select``, no host sync); a chunk it skips is wholly masked,
    and a wholly masked chunk adds exactly nothing once a valid one
    rescales the running sums by exp(NEG_INF - m) = 0, so the output is
    the full scan's bit for bit."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    cq, ck = min(spec.q_chunk, sq), min(spec.kv_chunk, sk)
    nq, nk = -(-sq // cq), -(-sk // ck)
    pad_q, pad_k = nq * cq - sq, nk * ck - sk
    scale = hd ** -0.5
    dev = q.device
    qf = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q)) if pad_q else q
    kf = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k)) if pad_k else k
    vf = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k)) if pad_k else v
    qs = qf * scale
    outs = []
    for qi in range(nq):
        q_i = qs[:, qi * cq:(qi + 1) * cq]
        q_pos = torch.arange(cq, dtype=torch.int32, device=dev) \
            + q_offset + qi * cq
        m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, cq, hd), dtype=torch.float32, device=dev)
        q5 = q_i.reshape(b, cq, kvh, rep, hd)
        first, n = _kv_window(spec, q_offset, qi, cq, ck, nk)
        gather = isinstance(first, torch.Tensor)
        if gather:
            idx = first + torch.arange(n, device=dev)
            kw = kf.reshape(b, nk, ck, kvh, hd).index_select(1, idx)
            vw = vf.reshape(b, nk, ck, kvh, hd).index_select(1, idx)
        for j in range(n):
            kj = first + j
            if gather:
                k_j, v_j = kw[:, j], vw[:, j]
            else:
                k_j = kf[:, kj * ck:(kj + 1) * ck]
                v_j = vf[:, kj * ck:(kj + 1) * ck]
            k_pos = torch.arange(ck, dtype=torch.int32, device=dev) + kj * ck
            mask = _mask_tile(spec, q_pos, k_pos)
            mask = torch.where((k_pos < sk)[None, :], mask, NEG_INF)
            s = _einsum("bqgrd,bkgd->bgrqk", q5, k_j).to(torch.float32)
            s = s.reshape(b, h, cq, ck) + mask[None, None]
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            p5 = p.to(v_j.dtype).reshape(b, kvh, rep, cq, ck)
            upd = _einsum("bgrqk,bkgd->bgrqd", p5, v_j).reshape(
                b, h, cq, hd)
            acc = acc * alpha[..., None] + upd.to(torch.float32)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.transpose(1, 2))  # [B, cq, H, hd]
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


def _decode_sdpa(spec: AttnSpec, q, k, v, kv_len):
    """Decode attention over the cache for C query lanes: JAX's
    ``_decode_sdpa`` (C = 1) and ``_verify_sdpa`` (the speculative verify
    step, C = K + 1) in one, the same einsums and masks.  q: [B, C, H, hd],
    lane i at absolute position ``kv_len - 1 + i``; k/v: [B, S_cache, KVH,
    hd]; kv_len: [B] valid lengths for lane 0.  Lane i sees i more
    positions: the draft tokens written before it in the same step."""
    b, c, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    q5 = (q * hd ** -0.5).reshape(b, c, kvh, rep, hd)
    scores = _einsum("bqgrd,bkgd->bgrqk", q5, k).to(torch.float32)
    k_pos = torch.arange(s, dtype=torch.int32, device=q.device)[None, None]
    row_len = kv_len[:, None] + torch.arange(c, dtype=torch.int32,
                                             device=q.device)[None, :]
    valid = k_pos < row_len[:, :, None]                       # [B, C, S]
    if spec.sliding_window is not None:
        valid &= k_pos >= (row_len[:, :, None] - spec.sliding_window)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = _einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype), v)
    return out.reshape(b, c, h, hd).to(q.dtype)


def _quant_kv(x):
    """[..., hd] -> int8 + per-(token, head) fp32 scale [..., 1]."""
    a = torch.clamp_min(x.to(torch.float32).abs().amax(-1, keepdim=True),
                        1e-8)
    q = torch.clamp(torch.round(x.to(torch.float32) * quant.div(127.0, a)),
                    -127, 127)
    return q.to(torch.int8), quant.div(a, 127.0)


def _dequant_kv(q, scale, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def _cache_kv(cache, dtype):
    """A one-shot cache's K and V to attend over: int8 ones dequantized
    to ``dtype`` by their per-(token, head) scales."""
    if cache["k"].dtype == torch.int8:
        return (_dequant_kv(cache["k"], cache["k_scale"], dtype),
                _dequant_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"], cache["v"]


def _qkv(params, spec: AttnSpec, x, positions, sp_cfg):
    q = _rope(spec, _split_heads(sl.apply(params["wq"], x, sp_cfg),
                                 spec.num_heads, spec.head_dim), positions)
    k = _rope(spec, _split_heads(sl.apply(params["wk"], x, sp_cfg),
                                 spec.num_kv_heads, spec.head_dim), positions)
    v = _split_heads(sl.apply(params["wv"], x, sp_cfg), spec.num_kv_heads,
                     spec.head_dim)
    return q, k, v


def apply(params, spec: AttnSpec, x, positions, sp_cfg: SparsityConfig,
          cache=None, kv_len=None, cross_kv=None):
    """Returns (out [B, S, D], cache | None).  With a cache {'k','v'}
    [B, S_max, KVH, hd] this is one decode token written at ``kv_len[0]``
    (uniform write position, batched decode), at a device index as JAX's
    ``dynamic_update_slice``; the cache is updated in place.  With
    ``cross_kv`` = (k, v) [B, T, KVH, hd] (the encoder's K/V) the queries
    attend over it non-causally and nothing is written.

    Under tensor parallelism the heads are this rank's (``spec``): q/k/v
    are column-parallel, their input entering through ``tp.enter`` (in
    training its gradient is summed over the ranks; under sequence
    parallelism the S-shards are gathered), and ``wo`` is row-parallel;
    so are a cross-attention's ``wq`` and ``wo``, given this rank's
    heads of the cross K/V.
    Under a sequence shard (``seq.activate``) the decode cache is this
    rank's S-slice of a cache holding every KV head
    (:func:`_decode_seq`)."""
    x = tp.enter(x)
    b, s, _ = x.shape
    if cross_kv is not None:
        q = _rope(spec, _split_heads(sl.apply(params["wq"], x, sp_cfg),
                                     spec.num_heads, spec.head_dim),
                  positions)
        out = _chunked_sdpa(dataclasses.replace(spec, causal=False,
                                                sliding_window=None),
                            q, *cross_kv)
        return sl.apply(params["wo"], out.reshape(b, s, spec.q_dim),
                        sp_cfg, reduce_out=True), cache
    q, k, v = _qkv(params, spec, x, positions, sp_cfg)
    shard = seq.current()
    if cache is None:
        out = _chunked_sdpa(spec, q, k, v)
    elif shard is not None:
        out = _decode_seq(spec, q, k, v, cache, kv_len, shard, x.dtype)
    else:
        pos = kv_len[:1].long()
        if cache["k"].dtype == torch.int8:
            k, ks = _quant_kv(k)
            v, vs = _quant_kv(v)
            cache["k_scale"].index_copy_(1, pos, ks)
            cache["v_scale"].index_copy_(1, pos, vs)
        cache["k"].index_copy_(1, pos, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, pos, v.to(cache["v"].dtype))
        out = _decode_sdpa(spec, q, *_cache_kv(cache, x.dtype), kv_len + 1)
    out = out.reshape(b, s, spec.q_dim)
    return sl.apply(params["wo"], out, sp_cfg, reduce_out=True), cache


# ------------------------------------------- the sequence-sharded decode
def _write_slot(kv_len, shard):
    """Where this rank writes the new token of a cache split along S:
    (the local index, whether this rank owns position ``kv_len[0]``), as
    device tensors; the index is clamped into the slice, where a rank
    that does not own the position writes back what it holds."""
    pos = kv_len[:1].long() - shard.offset
    own = (pos >= 0) & (pos < shard.length)
    return torch.clamp(pos, 0, shard.length - 1), own


def _seq_write(cache, k, v, kv_len, shard):
    """The new token's K/V (all KV heads, [B, 1, KVH, hd]; int8 caches
    their per-(token, head) scales too) into the rank that owns position
    ``kv_len[0]``, at its local index; no other rank changes."""
    idx, own = _write_slot(kv_len, shard)
    new = {"k": k, "v": v}
    if cache["k"].dtype == torch.int8:
        new["k"], new["k_scale"] = _quant_kv(k)
        new["v"], new["v_scale"] = _quant_kv(v)
    for name, val in new.items():
        leaf = cache[name]
        keep = leaf.index_select(1, idx)
        leaf.index_copy_(1, idx, torch.where(own.reshape(1, 1, 1, 1),
                                             val.to(leaf.dtype), keep))


def _decode_partials(spec: AttnSpec, q, k, v, kv_len, offset: int):
    """One query over this rank's S-slice (positions ``offset`` on) of
    the cache: ``_decode_sdpa``'s scores and masks, and instead of the
    softmax the slice's flash-decode partials (max m, sum of exponentials
    l, p@V) for :func:`seq.combine`.  A masked position's exponential is
    0, so a slice with no valid position gives l = 0 and p@V = 0 beside
    m = NEG_INF.  q: [B, 1, H, hd]; k/v: [B, S_local, KVH, hd]."""
    b, c, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    q5 = (q * hd ** -0.5).reshape(b, c, kvh, h // kvh, hd)
    scores = _einsum("bqgrd,bkgd->bgrqk", q5, k).to(torch.float32)
    k_pos = torch.arange(s, dtype=torch.int32, device=q.device)[None] \
        + offset
    valid = k_pos < kv_len[:, None]                           # [B, S]
    if spec.sliding_window is not None:
        valid &= k_pos >= (kv_len[:, None] - spec.sliding_window)
    valid = valid[:, None, None, None]
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(-1)
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    acc = _einsum("bgrqk,bkgd->bgrqd", p.to(v.dtype), v).to(torch.float32)
    return m, p.sum(-1), acc


def _decode_seq(spec: AttnSpec, q, k, v, cache, kv_len, shard, dtype):
    """One decode token over a cache split along S (``seq.current()``):
    this rank's heads of q and of the new K/V are gathered whole along
    the tensor-parallel ranks (the cache keeps every KV head), the new
    K/V written by the rank that owns its position, each rank's partials
    over its S-slice combined across every S axis, and this rank's heads
    of the output kept for the row-parallel ``wo``.  JAX's
    ``_decode_sdpa`` over the whole cache, GSPMD's split of it."""
    b, c, hl, hd = q.shape
    kl = k.shape[2]
    t = tp.size()
    if t > 1:
        g = tp.gather(torch.cat([q, k, v], 2), 2).reshape(
            b, c, t, hl + 2 * kl, hd)
        q = g[:, :, :, :hl].reshape(b, c, t * hl, hd)
        k = g[:, :, :, hl:hl + kl].reshape(b, c, t * kl, hd)
        v = g[:, :, :, hl + kl:].reshape(b, c, t * kl, hd)
    _seq_write(cache, k, v, kv_len, shard)
    m, l, acc = _decode_partials(spec, q, *_cache_kv(cache, dtype),
                                 kv_len + 1, shard.offset)
    out = seq.combine(m, l, acc, shard)          # [B, KVH, rep, 1, hd]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, c, t * hl, hd).to(q.dtype)
    r = tp.rank() if t > 1 else 0
    return out[:, :, r * hl:(r + 1) * hl]


def make_cache(spec: AttnSpec, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """dtype=int8 -> quantized cache with per-(token, kv-head) fp32 scales."""
    device = resolve_device(device)
    shape = (batch, max_len, spec.num_kv_heads, spec.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        sshape = (batch, max_len, spec.num_kv_heads, 1)
        cache["k_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                       device=device)
        cache["v_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                       device=device)
    return cache


def build_prefill_cache(params, spec: AttnSpec, x, positions,
                        sp_cfg: SparsityConfig, max_len: int,
                        dtype=torch.bfloat16):
    """Compute K/V for a full prompt and right-pad to max_len."""
    k = _rope(spec, _split_heads(sl.apply(params["wk"], x, sp_cfg),
                                 spec.num_kv_heads, spec.head_dim), positions)
    v = _split_heads(sl.apply(params["wv"], x, sp_cfg), spec.num_kv_heads,
                     spec.head_dim)
    pad = max_len - k.shape[1]
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    if dtype == torch.int8:
        kq, ks = _quant_kv(k)
        vq, vs = _quant_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k.to(dtype), "v": v.to(dtype)}


# ------------------------------------------------------------- paged KV
def make_paged_pool(spec: AttnSpec, num_pages: int, page_size: int,
                    dtype=torch.bfloat16, device=None):
    """Physical page pool shared by every sequence: ``num_pages`` pages
    [page_size, KVH, hd] plus one spare page at index ``num_pages``, the
    drop id.  The spare receives the writes JAX drops (``mode='drop'``);
    the page accounting hands out ids below ``num_pages`` only, so no
    page table names it and nothing reads it.  int8 pages carry
    per-(token, kv-head) fp32 scales."""
    device = resolve_device(device)
    shape = (num_pages + 1, page_size, spec.num_kv_heads, spec.head_dim)
    pool = {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        sshape = (num_pages + 1, page_size, spec.num_kv_heads, 1)
        pool["k_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                      device=device)
        pool["v_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                      device=device)
    return pool


def drop_page(pool) -> int:
    """The spare page's id, which marks a dropped write: the number of
    real pages."""
    return pool["k"].shape[0] - 1


def _pool_scatter(pool, page_ids, slot_ids, k_new, v_new):
    """Write per-token K/V rows [T, KVH, hd] into pages, in place, with no
    host synchronization.  ``page_id == drop_page(pool)`` marks a dropped
    write (pad tokens, inactive decode slots): JAX drops it with
    ``mode='drop'``; here it lands in the spare page, which no page table
    names.  Real rows address distinct (page, slot) pairs, and no dropped
    row shares one with a real row, so the writes never race."""
    pid, sid = page_ids.long(), slot_ids.long()
    if pool["k"].dtype == torch.int8:
        k_new, ks = _quant_kv(k_new)
        v_new, vs = _quant_kv(v_new)
        pool["k_scale"][pid, sid] = ks
        pool["v_scale"][pid, sid] = vs
    pool["k"][pid, sid] = k_new.to(pool["k"].dtype)
    pool["v"][pid, sid] = v_new.to(pool["v"].dtype)
    return pool


def pool_copy_pages(pool, src_ids, dst_ids):
    """Copy-on-write data plane: copy whole pages ``src_ids[i] ->
    dst_ids[i]`` in every leaf of one layer's pool, in place.  Every
    source is gathered before any write lands, so chained pairs in one
    call stay consistent (JAX's ``leaf.at[dst].set(leaf[src])``).  A
    padding lane names the spare page (``drop_page``) as its dst, where
    JAX drops the write; ``src`` is clamped to the real pages as JAX
    clamps it."""
    src = torch.clamp(src_ids.long(), 0, drop_page(pool) - 1)
    dst = dst_ids.long()
    for leaf in pool.values():
        leaf.index_copy_(0, dst, leaf.index_select(0, src))
    return pool


# bytes the gather path's rearrange materializes per call (every table
# slot's K/V page read at stored width + the int8 pools' fp32 scale rows,
# the dequantized contiguous copy written): the counter that
# ``kernels.roofline.pool_gather`` is held to in the tests, the bill the
# fused paged-attention kernel deletes
_GATHER_BYTES = [0.0]


def reset_gather_bytes() -> None:
    _GATHER_BYTES[0] = 0.0


def gather_bytes() -> float:
    return _GATHER_BYTES[0]


def _pool_gather(pool, page_table, dtype):
    """page_table [B, maxp] -> contiguous logical K/V [B, maxp*P, KVH, hd].
    Unallocated entries point at page 0; every position read from them is
    >= kv_len, where the masks zero it out."""
    b, maxp = page_table.shape
    ids = page_table.long()

    def g(leaf):
        return leaf[ids].reshape((b, maxp * leaf.shape[1])
                                 + tuple(leaf.shape[2:]))

    k, v = g(pool["k"]), g(pool["v"])
    if pool["k"].dtype == torch.int8:
        k = _dequant_kv(k, g(pool["k_scale"]), dtype)
        v = _dequant_kv(v, g(pool["v_scale"]), dtype)
    tokens = b * maxp * pool["k"].shape[1]
    kvh, hd = pool["k"].shape[2], pool["k"].shape[3]
    by = 2.0 * tokens * kvh * hd * (pool["k"].element_size()
                                    + dtype.itemsize)
    if pool["k"].dtype == torch.int8:
        by += 2.0 * tokens * kvh * 4.0              # fp32 scale rows
    _GATHER_BYTES[0] += by
    return k.to(dtype), v.to(dtype)


def pool_attend(spec: AttnSpec, q, pool, page_table, kv_len,
                sp_cfg: SparsityConfig, *, chunk_start=None):
    """THE paged-attention entry point of every paged step.

    q: [B, L, H, hd] post-RoPE queries (decode L = 1, verify L = K + 1,
    prefill chunk L = C); kv_len: [B] row-0 lengths (query row i sees
    ``kv_len + i`` positions).  ``chunk_start`` marks the prefill-chunk
    call site, whose oracle is the chunked SDPA at
    ``q_offset=chunk_start``."""
    if sp_cfg.fused_attention and spec.causal:
        from repro_torch.kernels import ops as kops
        # every call but a prefill chunk's keeps each query row on the
        # kernel's decode instance, so row i of a verify step is bit-equal
        # to a decode step at kv_len + i (spec on == spec off)
        return kops.paged_attention(q, pool, page_table, kv_len,
                                    sliding_window=spec.sliding_window,
                                    row_exact=chunk_start is None,
                                    tune=sp_cfg.tune)
    kd, vd = _pool_gather(pool, page_table, q.dtype)
    if chunk_start is not None:
        return _chunked_sdpa(spec, q, kd, vd, q_offset=chunk_start)
    return _decode_sdpa(spec, q, kd, vd, kv_len)


def paged_prefill_chunk(params, spec: AttnSpec, x, positions,
                        sp_cfg: SparsityConfig, pool, page_table,
                        start: torch.Tensor, real_len: torch.Tensor,
                        page_size: int):
    """Prefill chunk with history: x [1, C, D] holds prompt tokens
    [start, start+C), the last C - real_len rows right-padding; ``start``
    and ``real_len`` are int32 device scalars (0-d), as JAX's i32 scalars,
    so one captured step serves every chunk.  Writes the chunk's K/V into
    the sequence's pages, then attends causally over everything written
    so far.  Returns (out [1, C, D], pool)."""
    b, c, _ = x.shape
    maxp = page_table.shape[1]
    q, k_new, v_new = _qkv(params, spec, x, positions, sp_cfg)

    i = torch.arange(c, dtype=torch.int64, device=x.device)
    abs_pos = start + i
    # pad rows may run past the table: JAX clamps that gather, torch must;
    # their writes are dropped
    page_ids = page_table[0, torch.clamp(abs_pos // page_size, max=maxp - 1)]
    page_ids = torch.where(i < real_len, page_ids, drop_page(pool))
    _pool_scatter(pool, page_ids, abs_pos % page_size, k_new[0], v_new[0])

    kv_len0 = (start + 1).to(torch.int32).reshape(1).expand(b)
    out = pool_attend(spec, q, pool, page_table, kv_len0, sp_cfg,
                      chunk_start=start)
    return sl.apply(params["wo"], out.reshape(b, c, spec.q_dim), sp_cfg,
                    reduce_out=True), pool


def paged_decode_step(params, spec: AttnSpec, x, sp_cfg: SparsityConfig,
                      pool, page_table, kv_len, active, page_size: int):
    """One-token decode over the paged pool.  x: [B, 1, D]; kv_len: [B]
    pre-step lengths; active: [B] bool (inactive slots' writes are dropped
    and their outputs are garbage the engine ignores).
    Returns (out [B, 1, D], pool)."""
    b = x.shape[0]
    maxp = page_table.shape[1]
    q, k_new, v_new = _qkv(params, spec, x, kv_len[:, None], sp_cfg)

    col = torch.clamp(kv_len.long() // page_size, max=maxp - 1)
    page_ids = page_table[torch.arange(b, device=x.device), col]
    page_ids = torch.where(active, page_ids, drop_page(pool))
    _pool_scatter(pool, page_ids, kv_len % page_size, k_new[:, 0],
                  v_new[:, 0])

    out = pool_attend(spec, q, pool, page_table, kv_len + 1, sp_cfg)
    return sl.apply(params["wo"], out.reshape(b, 1, spec.q_dim), sp_cfg,
                    reduce_out=True), pool


def paged_verify_step(params, spec: AttnSpec, x, sp_cfg: SparsityConfig,
                      pool, page_table, kv_len, real_len, active,
                      page_size: int):
    """Speculative verify over the paged pool.  x: [B, C, D], per slot the
    last emitted token and its draft tokens, right-padded to C = K + 1
    lanes; kv_len: [B] pre-step write positions (the decode convention);
    real_len: [B] real lanes (1 + drafts); active: [B] bool.  Row i sits
    at kv_len + i; every real row's K/V is written first (pad lanes and
    inactive slots into the spare page), then each row attends causally.
    Rejected lanes are rolled back by the host not advancing kv_len past
    them.  Returns (out [B, C, D], pool)."""
    b, c, _ = x.shape
    maxp = page_table.shape[1]
    lane = torch.arange(c, dtype=torch.int32, device=x.device)
    positions = kv_len[:, None] + lane[None, :]                   # [B, C]
    q, k_new, v_new = _qkv(params, spec, x, positions, sp_cfg)

    # pad lanes may run past the table: JAX clamps that gather, torch must
    col = torch.clamp(positions.long() // page_size, max=maxp - 1)
    page_ids = torch.gather(page_table, 1, col)
    writable = (lane[None, :] < real_len[:, None]) & active[:, None]
    page_ids = torch.where(writable, page_ids, drop_page(pool))
    _pool_scatter(pool, page_ids.reshape(-1),
                  (positions % page_size).reshape(-1),
                  k_new.reshape((b * c,) + tuple(k_new.shape[2:])),
                  v_new.reshape((b * c,) + tuple(v_new.shape[2:])))

    out = pool_attend(spec, q, pool, page_table, kv_len + 1, sp_cfg)
    return sl.apply(params["wo"], out.reshape(b, c, spec.q_dim), sp_cfg,
                    reduce_out=True), pool
