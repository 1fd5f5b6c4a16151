"""Roofline terms of a step from counted FLOPs, bytes and collectives
(port of ``repro.launch.analysis``).

    compute    = FLOPs          / (chips * peak FLOP/s)
    memory     = bytes          / (chips * device memory rate)
    collective = collective bytes a device / link rate

JAX takes the FLOPs and bytes of a compiled program and parses the
collective bytes from its HLO text.  The port counts FLOPs and bytes of
the ops a step runs (``launch.op_cost``) and the collectives from the
``sharding.ctx.Mesh`` / ``sharding.tp`` collectives it runs
(``ctx.collectives_by_kind``), with JAX's ring wire-cost multipliers over
each collective's group size: all-gather and reduce-scatter (n-1)/n,
all-reduce 2(n-1)/n.  ``from_counts`` takes the place of
``from_compiled``.  ``model_flops_estimate``, ``model_bytes_estimate``
and ``_active_params`` are JAX's, verbatim.
"""
from __future__ import annotations

import dataclasses

# H100 SXM (NVIDIA's data sheet, dense, at 700 W)
PEAK_FLOPS = 989e12        # bf16 FLOP/s per GPU
HBM_BW = 3.35e12           # bytes/s per GPU
# one 400 Gb/s NDR InfiniBand port a GPU: every axis of the 16x16 and
# 2x16x16 production meshes spans more than one 8-GPU NVLink node (inside
# a node NVLink gives 450e9 B/s a direction)
LINK_BW = 50e9             # bytes/s per GPU


@dataclasses.dataclass
class Roofline:
    flops: float               # total global FLOPs (counted ops)
    hbm_bytes: float           # total global traffic estimate
    coll_bytes: float          # per-device collective wire bytes
    coll_breakdown: dict
    chips: int
    model_flops: float = 0.0   # analytic 6*N*D (or serving 2*N*D)
    model_bytes: float = 0.0   # analytic useful device traffic (global)
    raw_counts: dict | None = None  # the op counter's keys, as counted

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW  # already per-device

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful work vs the machine limit: the larger of the useful
        compute time and the useful memory-stream time, over the modeled
        step time (an MFU analogue that stays meaningful for memory-bound
        decode cells, whose useful FLOPs are tiny by construction)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        useful = max(self.model_flops / (self.chips * PEAK_FLOPS),
                     self.model_bytes / (self.chips * HBM_BW))
        return useful / t

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown, "chips": self.chips,
            "model_flops": self.model_flops, "model_bytes": self.model_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "raw_counts": self.raw_counts,
        }


def from_counts(counts: dict, collectives: dict, chips: int,
                model_flops: float = 0.0,
                model_bytes: float = 0.0) -> Roofline:
    """The roofline of a step whose ONE rank's ops counted ``counts``
    (``op_cost`` keys) and whose collectives tallied ``collectives``
    (``ctx.collectives_by_kind``): every rank of a production mesh runs
    the same ops, so the global FLOPs and bytes are ``chips`` x one
    rank's; the memory term takes the dot-traffic proxy (``bytes_dots``),
    the unfused bound stays in ``raw_counts``, as JAX's does."""
    coll = {kind: c["wire"] for kind, c in collectives.items()}
    return Roofline(flops=counts["flops"] * chips,
                    hbm_bytes=counts["bytes_dots"] * chips,
                    coll_bytes=sum(coll.values()), coll_breakdown=coll,
                    chips=chips, model_flops=model_flops,
                    model_bytes=model_bytes, raw_counts=dict(counts))


def model_bytes_estimate(cfg, shape) -> float:
    """Analytic *useful* HBM traffic per step (global), for the memory-side
    roofline fraction: parameters streamed per pass (+KV cache for decode).

    train:   3 passes over params (fwd + recompute + bwd) in bf16
             + optimizer state r/w (int8 m,v + scales ~ 2.1 B/param)
    prefill: 1 pass over params + cache write
    decode:  1 pass over (active) params + full cache read
    """
    params = _active_params(cfg)
    full_params = params
    if cfg.uses_moe:
        # memory streams *resident* experts, not just routed ones
        d, f = cfg.d_model, cfg.d_ff
        per_moe = 3 * d * f * (cfg.moe_num_experts - cfg.moe_top_k)
        full_params = params + per_moe * sum(cfg.moe_pattern) * cfg.num_units
    cache = 0.0
    if shape.kind in ("decode",):
        kv = cfg.num_kv_heads * cfg.resolved_head_dim
        n_attn = cfg.num_units * sum(k != "ssm" for k in cfg.unit_pattern)
        cache = 2 * shape.global_batch * shape.seq_len * kv * 2 * n_attn
    if shape.kind == "train":
        return full_params * 2 * 3 + full_params * 4.1
    if shape.kind == "prefill":
        return full_params * 2 + shape.global_batch * shape.seq_len * 1000
    return full_params * 2 + cache


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS per the brief: 6*N*D for training (N = params used in
    matmuls, D = tokens); 2*N_active*D for a forward/serving step; MoE uses
    active params only."""
    active = _active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active * tokens


def _active_params(cfg) -> float:
    """Matmul-visible parameters with MoE counted at top_k/E utilization."""
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim
    qdim, kvdim = cfg.num_heads * hd, cfg.num_kv_heads * hd
    total = 0.0
    for kind, is_moe in zip(cfg.unit_pattern, cfg.moe_pattern):
        if kind == "ssm":
            di = cfg.ssm_expand * d
            total += 2 * d * di + 2 * d * cfg.ssm_state \
                + d * (di // cfg.ssm_head_dim) + di * d
        else:
            total += d * qdim + 2 * d * kvdim + qdim * d
        if f:
            ffn = 3 * d * f
            total += ffn * cfg.moe_top_k if is_moe else ffn
    total *= cfg.num_units
    total += cfg.vocab_size * d  # LM head matmul (embed lookup is not a GEMM)
    if cfg.is_encoder_decoder:
        per = 2 * (d * qdim + 2 * d * kvdim + qdim * d) + 2 * d * f
        total += cfg.encoder_layers * per / 2 + cfg.num_layers * per
    return total
