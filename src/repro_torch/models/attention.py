"""Attention: GQA with RoPE and sliding windows, one-shot and paged.

Port of ``repro.models.attention``.  The one-shot path (prefill and the
dense-cache decode of ``generate``) is the chunked flash-style SDPA in
plain torch; the paged path writes K/V into a shared page pool and attends
through ``pool_attend``, which dispatches to the paged-attention kernel
(``sp_cfg.fused_attention``) or to the gather-then-SDPA oracle.

Where JAX silently clamps or drops, torch raises, so the table reads clamp
explicitly and the dropped writes land in a spare page that no page table
names (:func:`make_paged_pool`).  The pool is updated IN PLACE (the JAX
version returns a new pool): the engine holds one pool per layer and
never needs the old one, and in-place writes save a pool copy per step.
Nothing on the paged path reads a device value on the host, so a step is
one stream of launches that a CUDA graph can capture.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core import linear as sl, quant
from repro_torch.core.linear import SparsityConfig
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
    q_chunk: int = 1024
    kv_chunk: int = 1024

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


def _chunked_sdpa(spec: AttnSpec, q, k, v, q_offset=0):
    """q: [B, Sq, H, hd]; k/v: [B, Sk, KVH, hd] -> [B, Sq, H, hd].
    Two-level loop (query chunks, then KV chunks) with running
    (max, denom, acc): the FlashAttention dataflow in plain torch.
    ``q_offset``: an int, or an int32 device scalar (a prefill chunk's
    start)."""
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
        for kj in range(nk):
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
    """Single-query attention over the cache. q: [B, 1, H, hd];
    k/v: [B, S_cache, KVH, hd]; kv_len: [B] valid lengths."""
    b, _, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    q5 = (q * hd ** -0.5).reshape(b, 1, kvh, rep, hd)
    scores = _einsum("bqgrd,bkgd->bgrqk", q5, k).to(torch.float32)
    k_pos = torch.arange(s, dtype=torch.int32, device=q.device)[None, :]
    valid = k_pos < kv_len[:, None]
    if spec.sliding_window is not None:
        valid &= k_pos >= (kv_len[:, None] - spec.sliding_window)
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = _einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype), v)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def _quant_kv(x):
    """[..., hd] -> int8 + per-(token, head) fp32 scale [..., 1]."""
    a = torch.clamp_min(x.to(torch.float32).abs().amax(-1, keepdim=True),
                        1e-8)
    q = torch.clamp(torch.round(x.to(torch.float32) * quant.div(127.0, a)),
                    -127, 127)
    return q.to(torch.int8), quant.div(a, 127.0)


def _dequant_kv(q, scale, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def _qkv(params, spec: AttnSpec, x, positions, sp_cfg):
    q = _rope(spec, _split_heads(sl.apply(params["wq"], x, sp_cfg),
                                 spec.num_heads, spec.head_dim), positions)
    k = _rope(spec, _split_heads(sl.apply(params["wk"], x, sp_cfg),
                                 spec.num_kv_heads, spec.head_dim), positions)
    v = _split_heads(sl.apply(params["wv"], x, sp_cfg), spec.num_kv_heads,
                     spec.head_dim)
    return q, k, v


def apply(params, spec: AttnSpec, x, positions, sp_cfg: SparsityConfig,
          cache=None, kv_len=None):
    """Returns (out [B, S, D], cache | None).  With a cache {'k','v'}
    [B, S_max, KVH, hd] this is one decode token written at ``kv_len[0]``
    (uniform write position, batched decode), at a device index as JAX's
    ``dynamic_update_slice``; the cache is updated in place."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, spec, x, positions, sp_cfg)
    if cache is None:
        out = _chunked_sdpa(spec, q, k, v)
    else:
        pos = kv_len[:1].long()
        if cache["k"].dtype == torch.int8:
            k, ks = _quant_kv(k)
            v, vs = _quant_kv(v)
            cache["k_scale"].index_copy_(1, pos, ks)
            cache["v_scale"].index_copy_(1, pos, vs)
        cache["k"].index_copy_(1, pos, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, pos, v.to(cache["v"].dtype))
        if cache["k"].dtype == torch.int8:
            kd = _dequant_kv(cache["k"], cache["k_scale"], x.dtype)
            vd = _dequant_kv(cache["v"], cache["v_scale"], x.dtype)
        else:
            kd, vd = cache["k"], cache["v"]
        out = _decode_sdpa(spec, q, kd, vd, kv_len + 1)
    out = out.reshape(b, s, spec.q_dim)
    return sl.apply(params["wo"], out, sp_cfg), cache


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
    return k.to(dtype), v.to(dtype)


def pool_attend(spec: AttnSpec, q, pool, page_table, kv_len,
                sp_cfg: SparsityConfig, *, chunk_start=None):
    """THE paged-attention entry point of every paged step.

    q: [B, L, H, hd] post-RoPE queries; kv_len: [B] row-0 lengths (query
    row i sees ``kv_len + i`` positions).  ``chunk_start`` marks the
    prefill-chunk call site, whose oracle is the chunked SDPA at
    ``q_offset=chunk_start``."""
    if sp_cfg.fused_attention and spec.causal:
        from repro_torch.kernels import ops as kops
        return kops.paged_attention(q, pool, page_table, kv_len,
                                    sliding_window=spec.sliding_window)
    kd, vd = _pool_gather(pool, page_table, q.dtype)
    if chunk_start is not None:
        return _chunked_sdpa(spec, q, kd, vd, q_offset=chunk_start)
    if q.shape[1] == 1:
        return _decode_sdpa(spec, q, kd, vd, kv_len)
    raise NotImplementedError(
        "multi-lane paged attention outside a prefill chunk is the "
        "speculative verify step: not ported yet (ROADMAP A.5)")


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
    return sl.apply(params["wo"], out.reshape(b, c, spec.q_dim), sp_cfg), pool


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
    return sl.apply(params["wo"], out.reshape(b, 1, spec.q_dim), sp_cfg), pool
