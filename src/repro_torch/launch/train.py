"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of ``repro.launch.train``, single device, with the same flags
plus ``--device`` (default ``cuda``) and ``--log-every``.  Trains
``--arch`` (``--smoke``: its reduced same-family config) on the
synthetic stream, ``--sparse Z L`` with ``--sparse-mode masked`` (the
STE: pruned weights forward, dense gradients back) or ``dense``, AdamW
with fp32 or blockwise-int8 moments (``--opt-state``), and atomic async
checkpoints every ``--ckpt-every`` steps under ``--ckpt-dir``, from which
a rerun resumes exactly.  There are no XLA flags to set.  The closing
line gives the median step time after the first step, tokens/s at that
median and, on the card, the peak device memory, each beside the device.
"""
import argparse
import dataclasses
import json
import statistics

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.core.linear import SparsityConfig
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--sparse", nargs=2, type=int, metavar=("Z", "L"))
    ap.add_argument("--sparse-mode", default="masked",
                    choices=["masked", "dense"])
    ap.add_argument("--opt-state", default="float32",
                    choices=["float32", "int8"])
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = registry.smoke_config(args.arch) if args.smoke \
        else registry.get(args.arch)
    if args.sparse:
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
            pattern=tuple(args.sparse), mode=args.sparse_mode))

    opt = adamw.AdamWConfig(lr=args.lr, state_dtype=args.opt_state)
    tc = train_loop.TrainConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, log_every=args.log_every,
        global_batch=args.global_batch, seq_len=args.seq_len)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = train_loop.train(cfg, opt, tc, device=device)
    print(f"[launch.train] done at step {out['final_step']}; "
          f"final loss {out['losses'][-1]:.4f}" if out["losses"] else "")
    later = out["step_seconds"][1:]
    step_ms = statistics.median(later) * 1e3 if later else None
    on_card = device.type == "cuda"
    print("[launch.train] " + json.dumps({
        "device": (torch.cuda.get_device_name(device) if on_card
                   else str(device)),
        "losses": out["losses"],
        "median_step_ms": step_ms,
        "tokens_per_s": (args.global_batch * args.seq_len / step_ms * 1e3
                         if step_ms else None),
        "peak_device_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if on_card else None)}))
    return out


if __name__ == "__main__":
    main()
