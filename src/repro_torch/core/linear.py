"""SparseLinear — SlideSparse as a linear-layer feature (port).

One config object selects the execution path for every projection:

  mode='dense'       plain dense matmul (baseline)
  mode='compressed'  compressed storage, decompress-to-original matmul
                     (the hand-written CUDA kernel on the card, its plain
                     version on the CPU)
  mode='slided'      paper-faithful: Psi(x) @ Phi(W)^T over gamma*K; with a
                     quantized recipe one fused kernel quantizes, lifts and
                     multiplies (CUDA on the card, its plain version on the
                     CPU); the 'none' recipe runs ``slide.slided_matmul``
                     in plain torch, as the JAX package runs it outside
                     any Pallas kernel
  mode='masked'      training-time STE magnitude masking (sparse-aware
                     training): the pruned weights forward, dense
                     gradients back (``masks.ste_prune``), through the
                     same plain matmul as 'dense'

Precision composes through ``recipe`` (``precision.PrecisionRecipe``).
On the compressed path the per-token activation quantization stays plain
torch, outside the kernel, as the JAX package keeps it outside Pallas; on
the slided path it is the fused kernel's prologue (paper Alg. 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .patterns import Pattern, SlideDecomposition, TWO_FOUR
from . import slide, compressed as comp, masks, packer, precision, quant
from .precision import PrecisionRecipe


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    pattern: tuple[int, int] | None = None  # (Z, L), e.g. (6, 8)
    mode: str = "dense"  # dense | masked | compressed | slided
    act_quant: str | None = None  # legacy precision axis (None | 'int8')
    recipe: PrecisionRecipe | str | None = None
    # fuse the MLP SiLU into the gate projection's matmul epilogue
    fuse_epilogue: bool = False
    # serve paged KV steps through the fused paged-attention kernel
    # instead of the gather-then-SDPA oracle
    fused_attention: bool = False
    # one-shot tuning of the kernels' split counts per (op, shape) via
    # kernels.autotune; winners are cached in-process and on disk
    tune: bool = False

    def __post_init__(self):
        rec = precision.resolve(self.recipe, self.act_quant)
        if self.act_quant is not None and self.act_quant != rec.act:
            rec = precision.resolve(None, self.act_quant)
        object.__setattr__(self, "recipe", rec)
        object.__setattr__(self, "act_quant", rec.act)

    def decomposition(self) -> SlideDecomposition | None:
        if self.pattern is None:
            return None
        return SlideDecomposition(Pattern(*self.pattern), TWO_FOUR)


DENSE = SparsityConfig()


def _check_mode(cfg: SparsityConfig) -> None:
    if cfg.mode not in ("dense", "masked", "compressed", "slided"):
        raise ValueError(f"unknown mode {cfg.mode}")


def init(gen: torch.Generator, k_in: int, m_out: int,
         dtype=torch.float32, scale: float | None = None) -> dict[str, Any]:
    """Dense master weights [out, in] ~ N(0, 1) * k_in^-0.5, drawn in fp32
    on the generator's device then cast."""
    scale = scale if scale is not None else k_in ** -0.5
    w = torch.randn((m_out, k_in), generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return {"w": w.to(dtype)}


def prepare(params: dict[str, Any], cfg: SparsityConfig) -> dict[str, Any]:
    """Offline phase (§4.1) + load-time compression (§4.3): prune to the
    pattern, quantize per row per the recipe, Phi, then compress
    ('compressed', nibble-packed for 'w4'), or for 'slided' store Phi(W)
    as the fused kernel's 2:4 operand (``sp_values``, ``sp_meta``;
    ``fused_slide_matmul.sparse_operand``) under a quantized recipe and
    as the dense slided matrix ``w_slided`` under 'none'.  'dense' and
    'masked' pass through unchanged."""
    _check_mode(cfg)
    dec = cfg.decomposition()
    if cfg.mode in ("dense", "masked") or dec is None:
        return dict(params)
    rec = cfg.recipe
    w = packer.prune_to_pattern(params["w"], dec.source)
    out = {k: v for k, v in params.items() if k != "w"}
    if rec.quantized:
        qw = rec.quantize_weight(w)
        w_store, out["s_w"] = qw.q, qw.scale
    else:
        w_store = w
    ws = slide.phi(w_store, dec)
    if cfg.mode == "slided":
        if rec.quantized:
            from repro_torch.kernels import fused_slide_matmul as fsm
            out["sp_values"], out["sp_meta"] = fsm.sparse_operand(
                packer.pack_nibbles(ws) if rec.packed_weights else ws,
                packed=rec.packed_weights)
        else:
            out["w_slided"] = ws
        return out
    c = comp.compress(ws, dec, pack_values=rec.packed_weights)
    out["values"], out["indices"] = c.values, c.indices
    return out


def apply(params: dict[str, Any], x: torch.Tensor, cfg: SparsityConfig,
          activation: str | None = None, reduce_out: bool = False
          ) -> torch.Tensor:
    """y = act(x @ W^T) under the configured execution path. x: [..., K].
    ``activation`` (None | 'silu' | 'gelu') rides the kernel epilogue on
    the quantized slided and the compressed paths and is a separate
    elementwise op on the others — identical semantics
    (``kernels.ref.epilogue``).

    ``reduce_out`` marks the projection row-parallel under tensor
    parallelism (DESIGN.md §9; serving, and the split train step): the
    rank's partial output, taken after the epilogue, is summed over the
    ranks (``tp.reduce``: in training an autograd all-reduce whose
    backward is the identity, or under sequence parallelism a
    reduce-scatter along S; the masked path STE-prunes the rank's K-slice,
    which holds whole L-groups, ``tp.validate``).  ``activation`` is refused
    there (a nonlinearity on partial sums does not commute with the sum),
    and a quantized recipe quantizes with the global per-token absmax
    (``tp.reduce_max``), so every rank emits the unsharded run's quantized
    values and scale.  The partials are summed in fp32 and rounded once to
    the output dtype, as the unsharded epilogue rounds its fp32 value
    once.  Without an active tensor-parallel context ``reduce_out``
    changes nothing."""
    from repro_torch.kernels import ops as kops  # deferred: kernels import core
    from repro_torch.kernels import ref
    from repro_torch.sharding import tp

    _check_mode(cfg)
    dec = cfg.decomposition()
    rec = cfg.recipe
    sharded = reduce_out and tp.size() > 1
    if sharded and activation is not None:
        raise ValueError(
            f"activation={activation!r} cannot be fused into a "
            "row-parallel (reduce_out) projection under tensor "
            "parallelism: the epilogue would run on per-shard partial "
            "sums before the all-reduce")
    act_absmax = None
    if sharded and rec.quantized:
        act_absmax = tp.reduce_max(quant.absmax(x))
    # a row-parallel partial leaves the kernel in fp32
    out_dtype = torch.float32 if sharded else None

    def done(y, dtype):
        if not sharded:
            return y
        return tp.reduce(y.to(torch.float32)).to(dtype)

    if cfg.mode in ("dense", "masked") or dec is None:
        w = params["w"]
        if cfg.mode == "masked" and dec is not None:
            w = masks.ste_prune(w, dec.source)
        if rec.quantized:
            y = quant.matmul_dequant(rec.quantize_act(x, absmax=act_absmax),
                                     rec.quantize_weight(w),
                                     out_dtype or x.dtype)
        else:
            y = x @ w.to(x.dtype).T
        return done(ref.apply_activation(y, activation) if activation
                    else y, x.dtype)

    if not _prepared(params, cfg):
        params = prepare(params, cfg)
    if cfg.mode == "slided":
        if rec.quantized:
            return done(kops.slided_matmul_quant(
                x, params["sp_values"], params["sp_meta"], params["s_w"], dec,
                recipe=rec, out_dtype=out_dtype or x.dtype,
                activation=activation, act_absmax=act_absmax,
                tune=cfg.tune), x.dtype)
        y = slide.slided_matmul(x, params["w_slided"], dec).to(x.dtype)
        return done(ref.apply_activation(y, activation) if activation
                    else y, x.dtype)
    k = params["indices"].shape[-1] * dec.source.l // dec.source.z
    c = comp.CompressedSlided(
        params["values"], params["indices"], k, dec.source.z, dec.source.l,
        dec.hw.m, dec.hw.n, packed=rec.packed_weights)
    return done(kops.compressed_matmul(
        x, c, s_w=params.get("s_w"), recipe=rec, out_dtype=out_dtype,
        activation=activation, act_absmax=act_absmax, tune=cfg.tune),
        rec.out_dtype(x.dtype))


def _prepared(params: dict[str, Any], cfg: SparsityConfig) -> bool:
    if cfg.mode == "slided":
        return "sp_values" in params or "w_slided" in params
    return "values" in params
