"""End to end: train a ~100M-parameter LM for a few hundred steps
(port of ``examples/train_tiny_lm.py``).

Exercises the training substrate: the synthetic data pipeline with
prefetch, AdamW (fp32 or ``--int8-opt`` blockwise-int8 moments),
checkpoints every ``--ckpt-every`` steps with auto-resume from
``--ckpt-dir``, the straggler monitor, and optionally sparse-aware
(masked STE) training of a (2N-2):2N model (``--sparse Z L``).  The
default checkpoint directory is the port's own, never the JAX example's:
their formats differ.  Runs on the card unless ``--device`` names
another; the closing line gives the median step time beside the device.

Run:  python -m repro_torch.launch.train_tiny_lm [--steps 300]
      [--sparse 6 8] [--arch h2o-danube-3-4b] [--int8-opt]
"""
import argparse
import dataclasses
import os
import statistics
import tempfile

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.core.linear import SparsityConfig
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop


def hundred_m_config(arch: str, sparse=None) -> ModelConfig:
    """A ~100M-parameter member of the arch's family."""
    cfg = registry.get(arch)
    sp = (SparsityConfig(pattern=tuple(sparse), mode="masked")
          if sparse else SparsityConfig())
    return dataclasses.replace(
        cfg,
        num_layers=len(cfg.unit_pattern) * max(2, 8 // len(cfg.unit_pattern)),
        d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
        d_ff=min(cfg.d_ff, 2048) if cfg.d_ff else 0,
        vocab_size=32000, moe_num_experts=min(cfg.moe_num_experts, 8),
        moe_top_k=min(cfg.moe_top_k, 2), ssm_state=min(cfg.ssm_state, 64),
        sliding_window=256, encoder_layers=min(cfg.encoder_layers, 4),
        max_source_positions=min(cfg.max_source_positions, 64),
        logits_chunk=128, dtype="float32", sparsity=sp)


def param_count(cfg: ModelConfig) -> int:
    """Elements of ``cfg``'s parameter tree, counted on fake tensors (no
    memory, no device)."""
    with FakeTensorMode():
        return M.param_count(M.init(cfg, torch.Generator().manual_seed(0)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--sparse", nargs=2, type=int, default=None,
                    metavar=("Z", "L"), help="masked-STE (Z,L) training")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_tiny_lm"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--int8-opt", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = hundred_m_config(args.arch, args.sparse)
    n = param_count(cfg)
    print(f"[tiny-lm] {cfg.name} family, {n/1e6:.1f}M params, "
          f"sparsity={cfg.sparsity.pattern} mode={cfg.sparsity.mode}")

    opt = adamw.AdamWConfig(
        lr=args.lr, state_dtype="int8" if args.int8_opt else "float32")
    tc = train_loop.TrainConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        log_every=20, global_batch=args.batch, seq_len=args.seq)
    out = train_loop.train(cfg, opt, tc, device=device)
    losses = out["losses"]
    if losses:
        k = max(1, len(losses) // 10)
        later = out["step_seconds"][1:]
        step_ms = (f"{statistics.median(later) * 1e3:.3f} ms" if later
                   else "not measured")
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else str(device))
        print(f"[tiny-lm] loss {sum(losses[:k])/k:.4f} -> "
              f"{sum(losses[-k:])/k:.4f} over {out['final_step']} steps "
              f"({out['stragglers_flagged']} straggler steps flagged); "
              f"median step {step_ms} after the first ({name})")
    return out


if __name__ == "__main__":
    main()
