"""Dispatch between the CUDA kernels and their plain versions.

The rule of ``repro.kernels.ops._auto``, with the device in place of the
backend: a CUDA tensor goes to the hand-written kernel, a CPU tensor to
the plain PyTorch version in ``ref``.  A CUDA tensor never reaches a plain
version, and no kernel failure falls back to one.  The kernels are built
(nvcc) and loaded (ctypes) by ``_build`` at their first launch.
``act_absmax`` lets a tensor-parallel row-parallel projection quantize
with the global per-token absmax, so each rank's quantized activations
are the unsharded run's: B1's path quantizes with it outside the kernel,
B3 takes it in place of its own absmax pass.

Launch knobs flow through ``autotune.tiles_for`` (JAX's key params:
``pattern``, ``adt``, ``wdt``, and ``kvh`` / ``hd`` / ``qh`` / ``lanes``
for B2; the port adds ``xdt`` / ``odt``, the activation and output
dtypes): a cached entry gives B1's and B3's split of K and B2's split of
the page table, ``tune=True`` searches where nothing is cached, and
otherwise each wrapper launches its heuristic's value.  B4 and B5 take
no run-time knob and launch without the autotuner.  A CPU tensor
takes the plain version and never reaches the autotuner, as JAX's
reference path skips it.

A fake tensor (``torch._subclasses.FakeTensorMode``, the dry run) takes
neither: the call returns an empty output of the kernel's shape and
dtype and records the kernel's ``roofline.op_cost`` (``dry_costs``).
"""
from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.core import precision
from repro_torch.core.compressed import CompressedSlided
from repro_torch.core.patterns import SlideDecomposition

from . import autotune, ref, roofline
from . import fused_quant_slide as _fqs
from . import fused_slide_matmul as _fsm
from . import paged_attention as _pa
from . import quant_matmul as _qmm
from . import slide_matmul as _smm


# every kernel's wrapper module, each counting its launches in ``_COUNTS``
_COUNTED = {"compressed_matmul": _smm, "paged_attention": _pa,
            "fused_slided_matmul": _fsm, "fused_quant_slide": _fqs,
            "quant_matmul": _qmm}


def launch_counts() -> dict[str, dict[str, int]]:
    """A copy of every kernel's counters (launches; B1 also its
    decompressed tiles)."""
    return {name: dict(mod._COUNTS) for name, mod in _COUNTED.items()}


def add_launch_counts(delta: dict[str, dict[str, int]]) -> None:
    """Add ``delta`` to the counters: the launches of one CUDA graph
    replay, recorded when the graph was captured."""
    for name, counts in delta.items():
        for key, n in counts.items():
            _COUNTED[name]._COUNTS[key] += n


@contextlib.contextmanager
def recorded_launches():
    """Around a CUDA graph capture: the wrappers called inside count as
    usual, but a capture records launches and runs none, so at exit the
    counters are put back and the yielded dict holds what the block
    counted, which each replay of the graph then adds."""
    before = launch_counts()
    delta: dict[str, dict[str, int]] = {}
    try:
        yield delta
    finally:
        after = launch_counts()
        for name, counts in before.items():
            _COUNTED[name]._COUNTS.update(counts)
            delta[name] = {k: after[name][k] - n for k, n in counts.items()}


# op -> {"calls", "bytes", "flops"} of the kernel calls given fake tensors
_DRY: dict[str, dict[str, float]] = {}


def dry_costs() -> dict[str, dict[str, float]]:
    """What the kernels given fake tensors would have cost, by op: calls
    and the ``roofline.op_cost`` bytes and FLOPs summed over them."""
    return {op: dict(c) for op, c in _DRY.items()}


def reset_dry_costs() -> None:
    _DRY.clear()


def _dry(x: torch.Tensor, shape, dtype, keyfn, *args) -> torch.Tensor:
    """The empty output of a kernel call on fake tensors, its
    ``roofline.op_cost`` at ``keyfn(*args)`` = (op, rows, m, k, key
    params) recorded."""
    op, rows, m, k, params = keyfn(*args)
    cost = roofline.op_cost(op, rows=rows, m=m, k=k, **params)
    c = _DRY.setdefault(op, {"calls": 0, "bytes": 0.0, "flops": 0.0})
    c["calls"] += 1
    if cost is not None:
        c["bytes"] += cost.bytes
        c["flops"] += cost.flops
    return torch.empty(shape, dtype=dtype, device=x.device)


def _on_card(x: torch.Tensor) -> bool:
    """A CUDA tensor launches the kernel; any other takes the plain
    version (the one seam between the two, which a CPU test replaces)."""
    return x.is_cuda


def _tiles(tune: bool, run, operands: tuple, keyfn, *args,
           priced_k=None) -> autotune.TileConfig:
    """The call's knobs: ``autotune.tiles_for`` at ``keyfn(*args)`` =
    (op, rows, m, k, key params), with a runner whose launches leave the
    launch counters as they were (tuning is not the main path's).  The
    key is a function of ``args`` alone, so ``(keyfn, *args)`` is the
    memo under which a launch whose knobs are resolved already finds
    them without building its key.  ``priced_k``: as ``tiles_for``'s."""
    memo = (keyfn, *args)
    if not tune:
        got = autotune.resolved(memo)
        if got is not None:
            return got
    op, rows, m, k, params = keyfn(*args)

    def uncounted(t):
        with recorded_launches():
            return run(t)
    return autotune.tiles_for(op, rows=rows, m=m, k=k, tune=tune,
                              run=uncounted, operands=operands, memo=memo,
                              priced_k=priced_k, **params)


# The key functions: (op, rows, m, k, key params) of a kernel call from
# its hashable shapes and types, the one description of each key.
def _b1_key(rows, m, k, vdt, odt, act, weight, z, l):
    vdt = roofline.dtype_name(vdt)
    return "compressed_matmul", rows, m, k, dict(
        pattern=f"{z}:{l}", adt=act or vdt, wdt=weight or vdt,
        odt=roofline.dtype_name(odt))


def _b2_key(b, lanes, maxp, page_size, kvh, hd, h, kvdt, qdt, window):
    # JAX's key convention: rows = batch * lanes
    return "paged_attention", b * lanes, kvh * hd, maxp * page_size, dict(
        adt=roofline.dtype_name(kvdt), xdt=roofline.dtype_name(qdt),
        kvh=kvh, hd=hd, qh=h, window=window or 0, lanes=lanes)


def _b3_key(rows, m, k, xdt, odt, act, weight, z, l):
    return "fused_slided_matmul", rows, m, k, dict(
        pattern=f"{z}:{l}", xdt=roofline.dtype_name(xdt), adt=act,
        wdt=weight, odt=roofline.dtype_name(odt), wfmt="2:4")


def _b4_key(rows, k, xdt, act, z, l):
    return "fused_quant_slide", rows, 0, k, dict(
        pattern=f"{z}:{l}", xdt=roofline.dtype_name(xdt), adt=act)


def _b5_key(rows, m, k, adt, wdt, odt):
    return "quant_matmul", rows, m, k, dict(
        adt=roofline.dtype_name(adt), wdt=roofline.dtype_name(wdt),
        odt=roofline.dtype_name(odt))


def _family(dec: SlideDecomposition) -> int:
    n = dec.source.family_n
    if n is None or dec.hw.m != 2 or dec.hw.n != 4:
        raise ValueError("the kernel supports the (2N-2):2N -> 2:4 family")
    return n


def fused_quant_slide(x: torch.Tensor, dec: SlideDecomposition, recipe=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token quantization + lifting Psi (paper Alg. 1).
    x: [..., K] float -> (q [..., gamma*K] int8 | e4m3, scale [..., 1]
    fp32).  ``recipe`` selects the quantizer (default: int8)."""
    rec = precision.resolve(recipe if recipe is not None else "int8")
    if not rec.quantized:
        raise ValueError(f"recipe {rec.name!r} has no activation quantizer"
                         " to fuse the lift into")
    n = _family(dec)
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    rows, k = x2.shape
    fp8 = rec.act == "fp8"
    if isinstance(x2, FakeTensor):
        q = _dry(x2, (rows, roofline.lifted_k(k, n)),
                 torch.float8_e4m3fn if fp8 else torch.int8, _b4_key, rows,
                 k, x2.dtype, rec.act, dec.source.z, dec.source.l)
        s = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    elif _on_card(x2):
        q, s = _fqs.fused_quant_slide_cuda(x2, n_fam=n, fp8=fp8)
    else:
        q, s = ref.fused_quant_slide(x2, dec, fp8=fp8)
    return q.reshape(lead + (q.shape[-1],)), s.reshape(lead + (1,))


def quant_matmul(q_x: torch.Tensor, s_x: torch.Tensor, q_w: torch.Tensor,
                 s_w: torch.Tensor, out_dtype=torch.float32,
                 bias: torch.Tensor | None = None,
                 activation: str | None = None) -> torch.Tensor:
    """Dense quantized GEMM + dequant epilogue (the quantized baseline).
    q_x: [..., K] int8 | e4m3; s_x: [..., 1] fp32; q_w: [M, K]; s_w:
    [M, 1] fp32.  Returns [..., M] in ``out_dtype``."""
    lead = tuple(q_x.shape[:-1])
    x2 = q_x.reshape(-1, q_x.shape[-1]).contiguous()
    s2 = s_x.reshape(-1, 1).contiguous()
    rows, k = x2.shape
    m = q_w.shape[0]
    if isinstance(x2, FakeTensor):
        y = _dry(x2, (rows, m), out_dtype, _b5_key, rows, m, k, x2.dtype,
                 q_w.dtype, out_dtype)
    elif _on_card(x2):
        y = _qmm.quant_matmul_cuda(x2, s2, q_w, s_w, bias,
                                   out_dtype=out_dtype, activation=activation)
    else:
        y = ref.quant_matmul(x2, s2, q_w, s_w, out_dtype, bias, activation)
    return y.reshape(lead + (y.shape[-1],))


def slided_matmul_quant(x: torch.Tensor, sp_values: torch.Tensor,
                        sp_meta: torch.Tensor, s_w: torch.Tensor,
                        dec: SlideDecomposition, recipe="int8", out_dtype=None,
                        bias: torch.Tensor | None = None,
                        activation: str | None = None,
                        act_absmax: torch.Tensor | None = None,
                        tune: bool = False) -> torch.Tensor:
    """The paper's GPU path as ONE kernel: per-token quantization and
    lifting in the GEMM prologue, so the lifted gamma*K activations never
    reach device memory.  int8 or e4m3 activations against the 2:4
    operand of the slided weights (``fused_slide_matmul.sparse_operand``
    of Phi(W), int8 or nibble-packed int4), M = ``s_w.shape[0]``.
    ``act_absmax`` [..., 1]: the per-token absmax to quantize with (the
    kernel then skips its own absmax pass)."""
    rec = precision.resolve(recipe)
    if not rec.quantized:
        raise ValueError(f"recipe {rec.name!r} has no quantized GEMM form")
    n = _family(dec)
    out_dtype = out_dtype or rec.out_dtype(x.dtype)
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    aa = _flat_absmax(act_absmax)
    rows, k = x2.shape
    m = s_w.shape[0]

    args = (rows, m, k, x2.dtype, out_dtype, rec.act, rec.weight,
            dec.source.z, dec.source.l)
    if isinstance(x2, FakeTensor):
        y = _dry(x2, (rows, m), out_dtype, _b3_key, *args)
    elif _on_card(x2):
        def run(t):
            return _fsm.fused_slided_matmul_cuda(
                x2, sp_values, sp_meta, s_w, bias, n_fam=n, act=rec.act,
                packed=rec.packed_weights, out_dtype=out_dtype,
                activation=activation, act_absmax=aa, splits=t.splits)
        y = run(_tiles(tune, run, (x2, sp_values), _b3_key, *args))
    else:
        y = ref.slided_matmul_sparse(x2, sp_values, sp_meta, s_w, dec, rec,
                                     out_dtype, bias=bias,
                                     activation=activation, act_absmax=aa)
    return y.reshape(lead + (y.shape[-1],))


def _flat_absmax(act_absmax: torch.Tensor | None) -> torch.Tensor | None:
    """[..., 1] per-token absmax -> [rows, 1], row-aligned with x2."""
    if act_absmax is None:
        return None
    return act_absmax.reshape(-1, 1).to(torch.float32).contiguous()


def compressed_matmul(x: torch.Tensor, c: CompressedSlided,
                      s_w: torch.Tensor | None = None, recipe=None,
                      out_dtype=None, bias: torch.Tensor | None = None,
                      activation: str | None = None,
                      act_absmax: torch.Tensor | None = None,
                      tune: bool = False) -> torch.Tensor:
    """y = act(x @ decompress(c)^T + bias) — the SlideSparse linear.

    Quantized recipes need rowwise s_w [out, 1] and quantize x per token
    (plain torch on either device), with ``act_absmax`` [..., 1] as the
    per-token absmax when given; ``c.packed`` must match the recipe's
    weight storage.  x: [..., K] -> [..., out]."""
    rec = precision.resolve(recipe)
    out_dtype = out_dtype or rec.out_dtype(x.dtype)
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    n = _family(c.decomposition)
    rows, m = x2.shape[0], c.indices.shape[0]
    args = (rows, m, c.k, c.values.dtype, out_dtype, rec.act, rec.weight,
            c.z, c.l)
    if isinstance(x2, FakeTensor):
        return _dry(x2, (rows, m), out_dtype, _b1_key,
                    *args).reshape(lead + (m,))
    if rec.quantized:
        if s_w is None:
            raise ValueError(f"recipe {rec.name!r} needs s_w row scales")
        if rec.packed_weights != c.packed:
            raise ValueError(
                f"recipe {rec.name!r} expects "
                f"{'nibble-packed' if rec.packed_weights else 'per-slot'} "
                f"values but the operand has packed={c.packed}")
        aa = _flat_absmax(act_absmax)
        if _on_card(x2):
            qx = rec.quantize_act(x2, absmax=aa)

            def run(t):
                return _smm.compressed_matmul_cuda(
                    qx.q, c.values, c.indices, qx.scale, s_w, bias, n_fam=n,
                    packed=c.packed, out_dtype=out_dtype,
                    activation=activation, splits=t.splits)
            y = run(_tiles(tune, run, (x2, c.values), _b1_key, *args))
        else:
            y = ref.compressed_matmul_quant(x2, c, s_w, rec, out_dtype,
                                            bias=bias, activation=activation,
                                            act_absmax=aa)
    else:
        if x2.is_floating_point() and not c.values.is_floating_point():
            raise TypeError(
                f"float activations ({x2.dtype}) against {c.values.dtype}"
                "-compressed weights: pass a quantized recipe with s_w row "
                "scales, or compress float weights for the float path")
        if _on_card(x2):
            xv = x2.to(c.values.dtype)

            def run(t):
                return _smm.compressed_matmul_cuda(
                    xv, c.values, c.indices, None, None, bias, n_fam=n,
                    out_dtype=out_dtype, activation=activation,
                    splits=t.splits)
            y = run(_tiles(tune, run, (x2, c.values), _b1_key, *args))
        else:
            y = ref.compressed_matmul_fp(x2, c, out_dtype, bias=bias,
                                         activation=activation)
    return y.reshape(lead + (y.shape[-1],))


def paged_attention(q: torch.Tensor, pool: dict, page_table: torch.Tensor,
                    kv_len: torch.Tensor, *,
                    sliding_window: int | None = None,
                    row_exact: bool = True,
                    tune: bool = False) -> torch.Tensor:
    """Fused paged flash attention over the page pool.

    q: [B, L, H, hd] post-RoPE queries; lane ``i`` of sequence ``b`` sees
    positions ``< kv_len[b] + i`` (and within ``sliding_window`` of its
    own position).  page_table: [B, maxp] int32 (unallocated entries 0);
    kv_len: [B] int32 row-0 lengths.  ``row_exact`` keeps every row on
    the kernel's decode (CUDA-core) instance, so lane ``i`` gives the bits
    of an L = 1 call at ``kv_len + i``; the prefill-chunk call site clears
    it to let bf16 queries take the tensor-core instance.  Returns
    [B, L, H, hd] in q.dtype.

    The split count's key holds ``lanes=1`` for every ``row_exact`` call,
    so a verify step takes a decode step's split (its rows then stay
    bit-equal to decode calls, whose merge order the split fixes)."""
    if q.shape[2] % pool["k"].shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads "
                         f"{pool['k'].shape[2]}")
    window = int(sliding_window) if sliding_window is not None else None
    b, lanes, h, hd = q.shape
    maxp, page_size, kvh = page_table.shape[1], *pool["k"].shape[1:3]
    args = (b, 1 if row_exact else lanes, maxp, page_size, kvh, hd, h,
            pool["k"].dtype, q.dtype, window)
    if isinstance(q, FakeTensor):
        return _dry(q, q.shape, q.dtype, _b2_key, b, lanes, *args[2:])
    if _on_card(q):
        kvl = kv_len.to(torch.int32).contiguous()
        run_args = (q.contiguous(), pool,
                    page_table.to(torch.int32).contiguous(), kvl, window,
                    row_exact)

        def run(t):
            return _pa.paged_attention_cuda(*run_args, splits=t.br)

        def tokens():
            # the mean over the batch of the tokens a sequence's call
            # reads (lane i sees kv_len + i positions, at most the
            # window's): a tuned entry's bound prices these, not the
            # table's capacity
            n = (kvl.to(torch.int64) + lanes - 1).clamp(max=maxp * page_size)
            if window:
                n = n.clamp(max=window + lanes - 1)
            return n.double().mean().item()
        return run(_tiles(tune, run, (q, pool["k"]), _b2_key, *args,
                          priced_k=tokens))
    # the JAX CPU default: ~128 tokens per loop block
    block_pages = max(1, min(maxp, max(1, 128 // page_size)))
    return ref.flash_paged(q, pool, page_table, kv_len, window, block_pages)
