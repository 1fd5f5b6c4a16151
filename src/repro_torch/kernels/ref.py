"""Plain PyTorch versions of the port's kernels.

They define the semantics the CUDA kernels must match, mirror the JAX
oracles (``repro.kernels.ref``, ``paged_attention._flash_ref`` and the
prologue helpers of ``fused_quant_slide``) op for op, and are the
execution path for tensors on the CPU.  On the card they
serve only as the comparison in tests and ``chip_smoke.py``: the
dispatchers in ``ops`` never route a CUDA tensor here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import compressed as comp, packer, precision, quant

NEG_INF = -1e30

ACTIVATIONS = {
    None: lambda v: v,
    "silu": lambda v: v * torch.sigmoid(v),  # jax.nn.silu's form
    "gelu": lambda v: F.gelu(v, approximate="tanh"),  # jax.nn.gelu default
}


def apply_activation(v: torch.Tensor, activation: str | None) -> torch.Tensor:
    """Shared epilogue nonlinearity."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported epilogue activation {activation!r};"
                         f" expected one of {sorted(ACTIVATIONS, key=str)}")
    return ACTIVATIONS[activation](v)


def epilogue(y: torch.Tensor, bias: torch.Tensor | None,
             activation: str | None) -> torch.Tensor:
    """Bias + nonlinearity on the fp32 accumulator, in the JAX order."""
    if bias is not None:
        y = y + bias.to(torch.float32)
    return apply_activation(y, activation)


def compressed_matmul_fp(x: torch.Tensor, c: comp.CompressedSlided,
                         out_dtype=None, bias=None,
                         activation: str | None = None) -> torch.Tensor:
    """Float path: decompress to the original layout, fp32 dense matmul.
    x: [rows, K] -> [rows, out]."""
    out_dtype = out_dtype or x.dtype
    w_rec = comp.decompress_original(c)
    acc = x.to(torch.float32) @ w_rec.to(torch.float32).T
    return epilogue(acc, bias, activation).to(out_dtype)


def compressed_matmul_quant(x: torch.Tensor, c: comp.CompressedSlided,
                            s_w: torch.Tensor, recipe, out_dtype=None,
                            bias=None, activation: str | None = None,
                            act_absmax: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Quantized path: per-token activation quantization (int8 or e4m3,
    with the rows' ``act_absmax`` [R, 1] when given), then
    :func:`compressed_matmul_dequant`.  s_w: [out, 1] fp32."""
    rec = precision.resolve(recipe)
    qx = rec.quantize_act(x, absmax=act_absmax)
    return compressed_matmul_dequant(qx.q, qx.scale, c, s_w,
                                     out_dtype or x.dtype, bias, activation)


def compressed_matmul_int8(x: torch.Tensor, c: comp.CompressedSlided,
                           s_w: torch.Tensor, out_dtype=None, bias=None,
                           activation: str | None = None) -> torch.Tensor:
    """The int8 instance of :func:`compressed_matmul_quant` (w8a8), JAX's
    legacy name."""
    return compressed_matmul_quant(x, c, s_w, "int8", out_dtype, bias=bias,
                                   activation=activation)


def compressed_matmul_dequant(q_x: torch.Tensor, s_x: torch.Tensor,
                              c: comp.CompressedSlided, s_w: torch.Tensor,
                              out_dtype, bias=None,
                              activation: str | None = None) -> torch.Tensor:
    """What the CUDA kernel computes on quantized operands: decompress the
    int8/int4 values, exact integer (or fp32 for e4m3) dot, dequant
    epilogue ``(acc * s_x) * s_w``, bias, activation, cast."""
    acc = quant.quant_dot(q_x, comp.decompress_original(c))
    y = acc.to(torch.float32) * s_x * s_w[:, 0][None, :]
    return epilogue(y, bias, activation).to(out_dtype)


def lift_pairs(q: torch.Tensor, n_fam: int) -> torch.Tensor:
    """Psi for (2N-2):2N -> 2:4 as the fused kernels realize it: window j
    of each 2N-group covers source pairs (j, j+1), so lifted word (g, j)
    is the four source columns starting at 2N*g + 2j.  q: [R, K] ->
    [R, gamma*K].  Moves bytes only (fp8 goes through a uint8 view)."""
    r, k = q.shape
    g = k // (2 * n_fam)
    raw = q.view(torch.uint8) if q.dtype == torch.float8_e4m3fn else q
    pairs = raw.reshape(r, g, n_fam, 2)
    lifted = torch.cat([pairs[:, :, :n_fam - 1], pairs[:, :, 1:]], dim=-1)
    lifted = lifted.reshape(r, g * (n_fam - 1) * 4)
    return lifted.view(q.dtype) if raw is not q else lifted


def quantize_rows(x: torch.Tensor, fp8: bool,
                  absmax: torch.Tensor | None = None) -> quant.Quantized:
    """The per-row quantizer of the fused kernels' prologue: exactly
    ``quant.quantize_int8`` / ``quant.quantize_fp8`` (IEEE ``127 / a``,
    round half to even; e4m3 clamped to +-448 before the cast)."""
    return (quant.quantize_fp8(x, absmax) if fp8
            else quant.quantize_int8(x, absmax))


def fused_quant_slide(x: torch.Tensor, dec, fp8: bool = False,
                      absmax: torch.Tensor | None = None):
    """Paper Alg. 1: per-row dynamic quantization + lifting.  x: [R, K] ->
    (q_lifted int8 | e4m3 [R, gamma*K], scale fp32 [R, 1])."""
    n = dec.source.family_n
    if n is None or dec.hw.m != 2 or dec.hw.n != 4:
        raise ValueError("the kernel supports the (2N-2):2N -> 2:4 family")
    qx = quantize_rows(x, fp8, absmax)
    return lift_pairs(qx.q, n), qx.scale


def fused_quant_slide_spans(x: torch.Tensor, dec, spans, fp8: bool = False):
    """B4's dataflow (``fused_quant_slide.spans``): each block of a row's
    cluster takes max|x| over its span [c0, c1) of source columns, the
    row's absmax is the max of those (order-free: equal to
    ``quant.absmax`` bit for bit) floored at 1e-8, then the row is
    quantized and lifted.  x: [R, K] -> (q [R, gamma*K], scale [R, 1])."""
    xa = x.to(torch.float32).abs()
    zero = torch.zeros((x.shape[0], 1), dtype=torch.float32, device=x.device)
    parts = [xa[:, c0:c1].amax(-1, keepdim=True) if c1 > c0 else zero
             for c0, c1 in spans]
    a = torch.clamp_min(torch.stack(parts).amax(0), 1e-8)
    return fused_quant_slide(x, dec, fp8=fp8, absmax=a)


def quant_matmul_split(q_x: torch.Tensor, s_x: torch.Tensor,
                       q_w: torch.Tensor, s_w: torch.Tensor, share: int,
                       out_dtype=torch.float32, bias=None,
                       activation: str | None = None) -> torch.Tensor:
    """B5's dataflow (``quant_matmul.share_for``): the contraction cut into
    shares of ``share`` columns, each share's partial dot, the partials
    summed in split order, then the epilogue.  Integer partials are exact,
    so this equals :func:`quant_matmul` bit for bit; with an e4m3 operand
    it is the fp32 sum in the kernel's split order."""
    acc = None
    for k0 in range(0, q_x.shape[1], share):
        p = quant.quant_dot(q_x[:, k0:k0 + share], q_w[:, k0:k0 + share])
        acc = p if acc is None else acc + p
    y = acc.to(torch.float32) * s_x * s_w[:, 0][None, :]
    return epilogue(y, bias, activation).to(out_dtype)


def quant_matmul(q_x: torch.Tensor, s_x: torch.Tensor, q_w: torch.Tensor,
                 s_w: torch.Tensor, out_dtype=torch.float32, bias=None,
                 activation: str | None = None) -> torch.Tensor:
    """Quantized GEMM + dequant epilogue ``(q_x @ q_w^T) * s_x * s_w``,
    then bias and activation: int32-exact for integer operands, fp32 with
    any e4m3 operand.  q_x: [R, K]; s_x: [R, 1]; q_w: [M, K]; s_w: [M, 1]."""
    return quant_matmul_split(q_x, s_x, q_w, s_w, max(1, q_x.shape[1]),
                              out_dtype, bias, activation)


def slided_matmul_quant(x: torch.Tensor, w_slided_q: torch.Tensor,
                        s_w: torch.Tensor, dec, recipe, out_dtype=None,
                        bias=None, activation: str | None = None,
                        act_absmax: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Paper-faithful quantized semantics: ``(Psi(q(x)) @ Phi(q(W))^T) *
    s_x * s_w`` over the gamma*K contraction, int8 or e4m3 activations
    against int8 or nibble-packed int4 slided weights."""
    rec = precision.resolve(recipe)
    q_lift, s_x = fused_quant_slide(x, dec, fp8=rec.act == "fp8",
                                    absmax=act_absmax)
    return slided_matmul_dequant(q_lift, s_x, w_slided_q, s_w,
                                 out_dtype or x.dtype, bias, activation,
                                 packed=rec.packed_weights)


def slided_matmul_int8(x: torch.Tensor, w_slided_q: torch.Tensor,
                       s_w: torch.Tensor, dec, out_dtype=None, bias=None,
                       activation: str | None = None) -> torch.Tensor:
    """The int8 instance of :func:`slided_matmul_quant`, JAX's legacy
    name."""
    return slided_matmul_quant(x, w_slided_q, s_w, dec, "int8", out_dtype,
                               bias=bias, activation=activation)


def slided_matmul_sparse(x: torch.Tensor, sp_values: torch.Tensor,
                         sp_meta: torch.Tensor, s_w: torch.Tensor, dec,
                         recipe, out_dtype=None, bias=None,
                         activation: str | None = None,
                         act_absmax: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """The fused kernel's function on its 2:4 operand
    (``fused_slide_matmul.sparse_operand``): invert the layout to Phi(W),
    then :func:`slided_matmul_quant` (with the rows' ``act_absmax`` [R, 1]
    when given).  M is ``s_w.shape[0]``."""
    from . import fused_slide_matmul as fsm  # the operand's layout

    rec = precision.resolve(recipe)
    gk = fsm.lifted_width(x.shape[-1], dec.source.family_n)
    ws = fsm.dense_from_operand(sp_values, sp_meta, s_w.shape[0], gk,
                                packed=rec.packed_weights)
    return slided_matmul_quant(x, ws, s_w, dec, rec, out_dtype, bias=bias,
                               activation=activation, act_absmax=act_absmax)


def slided_matmul_dequant(q_lift: torch.Tensor, s_x: torch.Tensor,
                          w_slided: torch.Tensor, s_w: torch.Tensor,
                          out_dtype, bias=None,
                          activation: str | None = None,
                          packed: bool = False) -> torch.Tensor:
    """What the fused CUDA kernel computes once its prologue has quantized
    and lifted x: unpack the 'w4' nibbles, then :func:`quant_matmul`."""
    if packed:
        w_slided = packer.unpack_nibbles(w_slided, q_lift.shape[-1])
    return quant_matmul(q_lift, s_x, w_slided, s_w, out_dtype, bias,
                        activation)


def flash_paged(q: torch.Tensor, pool: dict, page_table: torch.Tensor,
                kv_len: torch.Tensor, window: int | None,
                block_pages: int) -> torch.Tensor:
    """Flash paged attention, the mirror of ``_flash_ref``: a loop over
    blocks of ``block_pages`` pages up to the longest row, online softmax
    in fp32 with q pre-scaled by hd^-0.5, GQA rows grouped per KV head,
    row ``i`` of sequence ``b`` bounded by ``kv_len[b] + i`` (and by the
    sliding window), int8 pages dequantized from their scale pages before
    each dot.  q: [B, L, H, hd] -> [B, L, H, hd] in q.dtype."""
    b, lanes, h, hd = q.shape
    page_size, kvh = pool["k"].shape[1], pool["k"].shape[2]
    rep = h // kvh
    maxp = page_table.shape[1]
    bp = max(1, min(block_pages, maxp))
    pad = (-maxp) % bp
    # pad with page 0: its positions are >= maxp*P >= every row_len, so the
    # kv_len mask drops them (the convention of unallocated table entries)
    pt = F.pad(page_table, (0, pad)) if pad else page_table
    nblocks = (maxp + pad) // bp
    quantized = pool["k"].dtype == torch.int8
    tokens = bp * page_size
    dev = q.device

    q5 = (q.to(torch.float32) * hd ** -0.5).reshape(b, lanes, kvh, rep, hd)
    row_len = (kv_len.to(torch.int32)[:, None]
               + torch.arange(lanes, dtype=torch.int32, device=dev)[None, :])
    needed = min(max(0, (int(row_len.max()) + tokens - 1) // tokens),
                 nblocks)

    m = torch.full((b, kvh, rep, lanes), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, kvh, rep, lanes), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, rep, lanes, hd), dtype=torch.float32,
                      device=dev)
    for i in range(needed):
        ids = pt[:, i * bp:(i + 1) * bp].long()           # [B, bp]
        kb, vb = pool["k"][ids], pool["v"][ids]           # [B, bp, P, KVH, hd]
        if quantized:
            kb = kb.to(torch.float32) * pool["k_scale"][ids]
            vb = vb.to(torch.float32) * pool["v_scale"][ids]
        kb = kb.reshape(b, tokens, kvh, hd).to(torch.float32)
        vb = vb.reshape(b, tokens, kvh, hd).to(torch.float32)
        pos = i * tokens + torch.arange(tokens, dtype=torch.int32, device=dev)
        ok = pos[None, None, :] < row_len[:, :, None]     # [B, L, T]
        if window is not None:
            ok &= pos[None, None, :] >= row_len[:, :, None] - window
        okb = ok[:, None, None, :, :]
        s = torch.einsum("bqgrd,bkgd->bgrqk", q5, kb)
        s = torch.where(okb, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # the where guards the all-masked block: NEG_INF - NEG_INF is 0
        # and exp(0) would smuggle weight-1 garbage into l/acc
        p = torch.where(okb, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrqk,bkgd->bgrqd",
                                                    p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]     # [B, G, rep, L, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(b, lanes, h, hd).to(q.dtype)


def flash_paged_split(q: torch.Tensor, pool: dict, page_table: torch.Tensor,
                      kv_len: torch.Tensor, window: int | None,
                      splits: int) -> torch.Tensor:
    """Split flash paged attention, the mirror of ``_flash_pallas`` +
    ``_merge_splits``: the table is cut into ``ns = clamp(splits, 1, maxp)``
    ranges of ``pps = ceil(maxp / ns)`` pages (padded with page 0, whose
    positions the kv_len mask drops); each range folds its pages one at a
    time into an fp32 online-softmax partial ``(acc, m, l)``, and the
    partials merge as ``m* = max m_s``, ``w = exp(m_s - m*)``,
    ``out = sum acc_s w / max(sum l_s w, 1e-30)``.  A range with no
    visible position keeps ``m = NEG_INF, l = 0, acc = 0``.  The CUDA
    kernel computes this at its own ``splits``.  q: [B, L, H, hd] ->
    [B, L, H, hd] in q.dtype."""
    b, lanes, h, hd = q.shape
    page_size, kvh = pool["k"].shape[1], pool["k"].shape[2]
    rep = h // kvh
    maxp = page_table.shape[1]
    ns = max(1, min(splits, maxp))
    pps = -(-maxp // ns)
    pad = ns * pps - maxp
    pt = F.pad(page_table, (0, pad)) if pad else page_table
    pt = pt.reshape(b, ns, pps).long()
    quantized = pool["k"].dtype == torch.int8
    dev = q.device

    q5 = (q.to(torch.float32) * hd ** -0.5).reshape(b, lanes, kvh, rep, hd)
    row_len = (kv_len.to(torch.int32)[:, None]
               + torch.arange(lanes, dtype=torch.int32, device=dev)[None, :])
    shape = (b, kvh, ns, rep, lanes)
    m = torch.full(shape, NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(shape, dtype=torch.float32, device=dev)
    acc = torch.zeros(shape + (hd,), dtype=torch.float32, device=dev)
    offs = torch.arange(page_size, dtype=torch.int32, device=dev)
    for p in range(pps):
        ids = pt[:, :, p]                                 # [B, ns]
        kb, vb = pool["k"][ids], pool["v"][ids]           # [B, ns, P, KVH, hd]
        if quantized:
            kb = kb.to(torch.float32) * pool["k_scale"][ids]
            vb = vb.to(torch.float32) * pool["v_scale"][ids]
        kb, vb = kb.to(torch.float32), vb.to(torch.float32)
        pos = ((torch.arange(ns, dtype=torch.int32, device=dev) * pps + p)
               * page_size)[:, None] + offs[None, :]      # [ns, P]
        ok = pos[None, None] < row_len[:, :, None, None]  # [B, L, ns, P]
        if window is not None:
            ok &= pos[None, None] >= row_len[:, :, None, None] - window
        okb = ok.permute(0, 2, 1, 3)[:, None, :, None]    # [B,1,ns,1,L,P]
        s = torch.einsum("bqgrd,bskgd->bgsrqk", q5, kb)
        s = torch.where(okb, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p_ = torch.where(okb, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p_.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bgsrqk,bskgd->bgsrqd",
                                                    p_, vb)
        m = m_new
    m_star = m.amax(2, keepdim=True)
    w = torch.exp(m - m_star)
    l_star = (l * w).sum(2)
    out = (acc * w[..., None]).sum(2) / torch.clamp_min(l_star, 1e-30)[
        ..., None]                                        # [B, G, rep, L, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(b, lanes, h, hd).to(q.dtype)
