"""Sparsity-accuracy sweep — the shape of paper Figure 2 on a tiny LM
(port of ``examples/sparsity_sweep.py``).

The paper fine-tunes Qwen3 under Dense / 6:8 / 2:4 and shows 6:8
preserves accuracy while 2:4 collapses.  This proxy trains a small LM
from scratch under each (masked-STE) regime on the synthetic pipeline
and reports the final loss: the ordering dense <= 6:8 << 2:4 is the
claim to read, not a gate.

``--precision`` adds the recipe axis: after fp32 training, each regime
is also evaluated under the recipe-quantized forward (per-token int8/fp8
activations, int8/int4 rowwise weights; ``models.model.loss_fn`` in
masked mode with the recipe) on a held-out batch.  Training always runs
fp32 (round-to-nearest has a zero gradient).

No CUDA kernel of the port runs here: training launches none, and masked
mode with a recipe is ``quant.matmul_dequant`` in plain torch, as JAX's
masked path is its plain ``_plain`` product.

Run:  python -m repro_torch.launch.sparsity_sweep [--steps 150]
      python -m repro_torch.launch.sparsity_sweep --precision w4
"""
import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.core.linear import SparsityConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop

REGIMES = {
    "dense": None,
    "10:12": (10, 12),
    "6:8": (6, 8),
    "4:6": (4, 6),
    "2:4": (2, 4),
}
EVAL_SEED = 1234


def base_config() -> ModelConfig:
    """danube's smoke config at the sweep's size: every projection width
    (d_model, d_ff, q/kv dims) a multiple of lcm(12, 8, 6, 4) = 24, so
    every regime's L-groups divide evenly."""
    base = registry.smoke_config("h2o-danube-3-4b")
    return dataclasses.replace(base, d_model=96, num_heads=8, num_kv_heads=4,
                               head_dim=12, d_ff=192, vocab_size=2048,
                               num_layers=4, logits_chunk=64)


def regime_config(base: ModelConfig, pattern) -> ModelConfig:
    sp = (SparsityConfig(pattern=pattern, mode="masked") if pattern
          else SparsityConfig())
    return dataclasses.replace(base, sparsity=sp)


def train_regime(cfg: ModelConfig, steps: int, batch: int, seq: int,
                 device) -> dict:
    """``train_loop.train``'s summary of one regime's fp32 run."""
    return train_loop.train(
        cfg, adamw.AdamWConfig(lr=3e-3),
        train_loop.TrainConfig(steps=steps, log_every=0, global_batch=batch,
                               seq_len=seq), device=device)


def eval_loss(params, cfg: ModelConfig, recipe: str, batch: int, seq: int,
              device) -> float:
    """The loss of ``params`` under ``recipe``'s quantized forward on the
    held-out batch (``SyntheticLM`` seed ``EVAL_SEED``, step 0): masked
    mode with the recipe, the dense same-precision reference the
    compressed serving pipeline is held to."""
    qcfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, act_quant=None, recipe=recipe))
    b = SyntheticLM(qcfg, batch, seq, seed=EVAL_SEED,
                    device=device).device_batch_at(0)
    with torch.no_grad():
        return float(M.loss_fn(params, qcfg, b))


def sweep(args, device) -> dict:
    """Train each regime (``args``: steps, batch, seq, precision) on
    ``device``; returns {regime: (per-step losses, final loss (the mean
    of the last tenth), eval loss under ``args.precision`` or None)}."""
    base = base_config()
    quantized = args.precision and args.precision != "none"
    out = {}
    for name, pat in REGIMES.items():
        cfg = regime_config(base, pat)
        res = train_regime(cfg, args.steps, args.batch, args.seq, device)
        losses = res["losses"]
        k = max(1, args.steps // 10)
        final = sum(losses[-k:]) / k
        line = f"[sweep] {name:>6}: final loss {final:.4f}"
        qloss = None
        if quantized:
            qloss = eval_loss(res["params"], cfg, args.precision, args.batch,
                              args.seq, device)
            line += f"  |  {args.precision} eval loss {qloss:.4f}"
        print(line)
        out[name] = (losses, final, qloss)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--precision", default=None,
                    choices=["none", "int8", "fp8", "w4", "fp8w4"],
                    help="additionally evaluate each trained regime under "
                         "this precision recipe's quantized forward")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    results = sweep(args, device)
    quantized = any(q is not None for _, _, q in results.values())
    cols = "pattern  density  final-loss"
    if quantized:
        cols += f"  {args.precision}-eval-loss"
    print("\n" + cols + "  (lower = better)")
    for name, (_, loss, qloss) in results.items():
        dens = "1.000" if name == "dense" else \
            f"{int(name.split(':')[0]) / int(name.split(':')[1]):.3f}"
        row = f"{name:>7}  {dens:>7}  {loss:.4f}"
        if qloss is not None:
            row += f"  {qloss:.4f}"
        print(row)
    print("\nExpected ordering (paper Fig. 2): mild patterns track dense; "
          "2:4 degrades most.  Quantized-eval columns should track the "
          "fp32 losses closely (the paper's precision-robustness claim).")
    return results


if __name__ == "__main__":
    main()
