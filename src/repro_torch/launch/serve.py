"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

The port of ``repro.launch.serve``, with the same flags plus ``--device``
(default ``cuda``) and ``--fused-attention``: initializes weights from a
seeded ``torch.Generator``, runs the offline packer + load-time
compression, then serves batched requests through the one-shot loop or,
with ``--engine``, the continuous-batching paged-KV engine:
``--prefix-cache`` (radix prefix cache over copy-on-write pages),
``--speculate K --draft ngram|random`` (speculative decoding),
``--inject-faults SEED`` (deterministic allocation and step faults with
bounded retries) and ``--async`` (the overlapped loop).  ``--tp N`` with
``--engine`` runs the engine tensor-parallel over N ranks: the command
starts them itself (``sharding.dist``) or joins ``torchrun``'s, each rank
on ``cuda:{local_rank % device_count}`` (or ``--device cpu``), over the
``--dist-backend`` the caller names (``nccl``, the default, needs one
device per rank; ``gloo`` lets the ranks share a device); rank 0 prints
the streams and the stats.  ``--layers N`` cuts the depth at full
width; ``--dtype`` sets the activation and KV page dtype.  ``--arch`` takes every config of the registry: dense, MoE
(granite-moe, mixtral), Mamba-2 (mamba2), the jamba hybrid, qwen2-vl (M-RoPE; served
text-only, as JAX's launcher serves it) and whisper-small (the
encoder-decoder, fed seeded audio frames [B, 1500, d] in place of the
conv frontend; one-shot only: with ``--engine`` the engine refuses it,
as JAX's does).  An SSM stack's engine refuses ``--prefix-cache`` and
``--speculate``, as JAX's does.  The weights are random from a seeded
generator, an SSM block's ``wo`` drawn too (``init`` keeps JAX's zeros,
which make the block the identity).
"""
import argparse
import dataclasses
import json
import sys

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.core.linear import SparsityConfig
from repro_torch.models import model as M
from repro_torch.runtime import faults as fl, serve_loop
from repro_torch.sharding import dist as tdist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (full width)")
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                    help="activation and KV page dtype (default: the "
                         "config's)")
    ap.add_argument("--sparse", nargs=2, type=int, metavar=("Z", "L"))
    ap.add_argument("--act-quant", choices=["int8"], default=None,
                    help="legacy precision flag; maps onto --precision int8")
    ap.add_argument("--precision", default=None,
                    choices=["none", "int8", "fp8", "w4", "fp8w4"],
                    help="precision recipe: activation quantizer x weight "
                         "storage; overrides --act-quant")
    ap.add_argument("--fused-attention", action="store_true",
                    help="serve paged KV steps through the paged-attention "
                         "kernel instead of the gather-then-SDPA oracle")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--engine", action="store_true",
                    help="serve through the continuous-batching paged-KV "
                         "engine (staggered arrivals)")
    ap.add_argument("--tp", type=int, default=1,
                    help="engine mode: tensor-parallel ranks")
    ap.add_argument("--dist-backend", default="nccl",
                    choices=["nccl", "gloo"],
                    help="torch.distributed backend of the --tp ranks "
                         "(nccl needs one device per rank)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=256)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--policy", default="fcfs", choices=["fcfs", "priority"])
    ap.add_argument("--inject-faults", type=int, default=None,
                    metavar="SEED")
    ap.add_argument("--watchdog", action="store_true")
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--deadline-steps", type=int, default=None)
    ap.add_argument("--speculate", type=int, default=0, metavar="K")
    ap.add_argument("--draft", default="ngram", choices=["ngram", "random"])
    ap.add_argument("--async", dest="async_loop", action="store_true")
    args = ap.parse_args(argv)
    if args.tp > 1 and not args.engine:
        raise SystemExit("--tp requires --engine")
    rank = 0
    if args.tp > 1:
        joined = tdist.launcher_ranks(
            "repro_torch.launch.serve",
            sys.argv[1:] if argv is None else list(argv), args.tp,
            args.dist_backend, args.device)
        if joined is None:  # the ranks ran, rank 0's output printed
            return
        rank, device = joined
    else:
        device = resolve_device(args.device)

    cfg = registry.smoke_config(args.arch) if args.smoke \
        else registry.get(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype,
                                  kv_cache_dtype=args.dtype)
    if args.sparse:
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
            pattern=tuple(args.sparse), mode="compressed",
            recipe=args.precision, act_quant=args.act_quant,
            fused_attention=args.fused_attention))
    gen = torch.Generator(device=device).manual_seed(0)
    # an SSM block's wo is drawn too: init's zeros make the block the
    # identity
    params = serve_loop.pack_params(
        M.draw_ssm_wo(M.init(cfg, gen), cfg, gen), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device, dtype=torch.int32)
    audio = (torch.randn((args.batch, cfg.max_source_positions, cfg.d_model),
                         generator=gen, device=device)
             if cfg.frontend == "audio" else None)

    if args.engine:
        plan = (fl.FaultPlan(seed=args.inject_faults, alloc_fail_rate=0.08,
                             step_error_rate=0.04)
                if args.inject_faults is not None else None)
        ecfg = serve_loop.EngineConfig(
            max_batch=args.batch, page_size=args.page_size,
            num_pages=args.num_pages,
            max_seq_len=args.prompt_len + args.new_tokens,
            prefill_chunk=args.prefill_chunk, policy=args.policy,
            max_queue=args.max_queue, watchdog=args.watchdog, tp=args.tp,
            prefix_cache=args.prefix_cache, speculate=args.speculate,
            draft_source=args.draft, async_loop=args.async_loop,
            faults=plan)
        eng = serve_loop.ServeEngine(params, cfg, ecfg, device=device)
        eng.warmup()
        for i in range(args.batch):
            eng.submit(tokens[i].tolist(), args.new_tokens, rid=i, arrival=i,
                       deadline_steps=args.deadline_steps)
        out = eng.run()
        eng.kv.check()  # pages balance, faults or not
        if args.tp > 1:
            torch.distributed.destroy_process_group()
            if rank:
                return
        s = eng.stats
        print(f"[launch.serve] engine(device={device}, tp={s.tp}, precision="
              f"{s.precision}, policy={ecfg.policy}): {len(out)} requests; "
              f"decode {s.decode_tok_s:.1f} tok/s "
              f"({s.decode_tok_s_per_device:.1f} per device); occupancy "
              f"{s.mean_occupancy:.2f}; evictions {s.evictions}; ok "
              f"{s.completed_ok}; sample: {out[0].tokens[:8]}")
        print("[launch.serve] streams: " + json.dumps(
            {rid: c.tokens for rid, c in sorted(out.items())}))
        if args.prefix_cache:
            print(f"[launch.serve] prefix cache: hit_rate "
                  f"{s.prefix_hit_rate:.2f}; {s.prefill_chunks_skipped} "
                  f"chunks skipped; {s.cow_copies} COW copies")
        if args.speculate > 0:
            print(f"[launch.serve] speculative: K={args.speculate} "
                  f"source={args.draft}; {s.verify_steps} verify steps; "
                  f"accepted {s.accepted_tokens}/{s.draft_tokens} "
                  f"(rate {s.acceptance_rate:.2f})")
        if args.async_loop:
            print(f"[launch.serve] async loop: {s.lookahead_steps} "
                  f"lookahead dispatches; host gap {s.host_gap_s * 1e3:.1f}"
                  f"ms; overlap {s.overlap_frac:.2f}; d2h {s.d2h_bytes}B")
        if plan is not None or args.watchdog or args.max_queue is not None \
                or args.deadline_steps is not None:
            print(f"[launch.serve] lifecycle: ok={s.completed_ok} "
                  f"cancelled={s.cancelled} timeouts={s.timeouts} "
                  f"rejected={s.rejected} failed={s.failed} "
                  f"quarantined={s.quarantined}; goodput "
                  f"{s.goodput_tok_s:.1f} tok/s; faults_injected="
                  f"{s.faults_injected}; p95_queue_wait="
                  f"{s.p95_queue_wait_steps:.0f} steps; kv invariants OK")
        return

    toks, stats = serve_loop.generate(params, cfg, tokens, args.new_tokens,
                                      extra_embeds=audio)
    print(f"[launch.serve] prefill {stats.prefill_s:.2f}s; decode "
          f"{stats.decode_tok_s:.1f} tok/s; sample: {toks[0][:8].tolist()}")


if __name__ == "__main__":
    main()
