"""Architecture configuration schema (static/hashable: safe as jit constants)."""
from __future__ import annotations

import dataclasses

from repro_torch.core.linear import SparsityConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # per-layer kind pattern, repeated num_layers/len times (scanned units)
    # entries: 'attn' (full), 'swa' (sliding window), 'ssm' (Mamba-2)
    unit_pattern: tuple[str, ...] = ("attn",)
    # FFN kind per unit position: True -> MoE, False -> dense SwiGLU
    moe_pattern: tuple[bool, ...] = (False,)

    # attention
    rope_theta: float = 1e4
    sliding_window: int = 4096
    m_rope: bool = False

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    # hillclimb A: pad the expert *stacks* (not the router) to a multiple of
    # the TP axis so expert parallelism applies when E doesn't divide it
    # (granite 40e -> 48 on a 16-way axis; pads receive no tokens)
    moe_expert_padding: int = 0

    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # SSD intra-chunk length: the L decay matrix is [B,H,C,Q,Q] — Q^2 per
    # chunk, so wide-d_inner hybrids (jamba: H=256) need a smaller Q
    ssm_chunk: int = 256

    # encoder-decoder (audio family)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    max_source_positions: int = 1500

    # modality frontend stub ('audio' | 'vision' | None): input_specs()
    # provides precomputed frame/patch embeddings per the brief
    frontend: str | None = None

    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True
    remat_2level: bool = True        # segment-scanned remat (s1 x s2 units)
    sequence_parallel: bool = False  # Megatron-SP residual (see §Perf)
    swa_tile_skip: bool = False      # hillclimb C: windowed KV slicing
    kv_cache_dtype: str = "bfloat16"  # 'int8' halves decode cache traffic
    logits_chunk: int = 512         # sequence-chunked LM head + loss

    # SlideSparse integration (the paper's single flag, §4.3).  The config
    # also carries the precision recipe (SparsityConfig.recipe, DESIGN.md
    # §10): activation quantizer (int8 / fp8-e4m3) x weight storage (int8
    # rowwise / nibble-packed int4 'w4') — one registry entry per
    # precision, threaded from the kernel prologues to the serving engine
    sparsity: SparsityConfig = SparsityConfig()

    # --------------------------------------------------------- derived
    def __post_init__(self):
        if len(self.unit_pattern) != len(self.moe_pattern):
            raise ValueError("unit_pattern and moe_pattern length mismatch")
        if self.num_layers % len(self.unit_pattern):
            raise ValueError(
                f"{self.num_layers} layers not divisible by unit of "
                f"{len(self.unit_pattern)}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_units(self) -> int:
        return self.num_layers // len(self.unit_pattern)

    @property
    def uses_moe(self) -> bool:
        return any(self.moe_pattern)

    @property
    def uses_ssm(self) -> bool:
        return "ssm" in self.unit_pattern

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: no unbounded-window full-attention-only
        stack (SSM/hybrid/SWA qualify; a few global layers are tolerated
        when the majority is local — gemma3/jamba style)."""
        kinds = self.unit_pattern
        full = sum(k == "attn" for k in kinds)
        return self.uses_ssm or full == 0 or full / len(kinds) <= 0.2

    def params_billions(self) -> float:
        """Analytic parameter count (embedding + per-layer) in 1e9."""
        d, f, hd = self.d_model, self.d_ff, self.resolved_head_dim
        qdim, kvdim = self.num_heads * hd, self.num_kv_heads * hd
        per_unit = 0
        for kind, is_moe in zip(self.unit_pattern, self.moe_pattern):
            if kind == "ssm":
                di = self.ssm_expand * d
                per_unit += 2 * d * di + 2 * d * self.ssm_state \
                    + d * (di // self.ssm_head_dim) + di * d
            else:
                per_unit += d * qdim + 2 * d * kvdim + qdim * d
            if f:
                ffn = 3 * d * f
                per_unit += ffn * self.moe_num_experts if is_moe else ffn
        total = per_unit * self.num_units
        total += 2 * self.vocab_size * d  # embed + head
        if self.is_encoder_decoder:
            total += self.encoder_layers * (4 * d * qdim + 3 * d * f
                                            + 4 * d * qdim)
        return total / 1e9
