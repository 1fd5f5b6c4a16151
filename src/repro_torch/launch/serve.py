"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

The port of ``repro.launch.serve``, with the same flags plus ``--device``
(default ``cuda``) and ``--fused-attention``: initializes weights from a
seeded ``torch.Generator``, runs the offline packer + load-time
compression, then serves batched requests through the one-shot loop or,
with ``--engine``, the continuous-batching paged-KV engine (``--async``:
the overlapped loop).  Flags of features not ported yet (``--tp``,
``--prefix-cache``, ``--speculate``, ``--inject-faults``) are accepted and
refused with ``NotImplementedError``.
"""
import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.core.linear import SparsityConfig
from repro_torch.models import model as M
from repro_torch.runtime import serve_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
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
    ap.add_argument("--tp", type=int, default=1)
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
    ap.add_argument("--draft", default="ngram")
    ap.add_argument("--async", dest="async_loop", action="store_true")
    args = ap.parse_args(argv)
    if args.tp > 1 and not args.engine:
        raise SystemExit("--tp requires --engine")
    device = resolve_device(args.device)

    cfg = registry.smoke_config(args.arch) if args.smoke \
        else registry.get(args.arch)
    if args.sparse:
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
            pattern=tuple(args.sparse), mode="compressed",
            recipe=args.precision, act_quant=args.act_quant,
            fused_attention=args.fused_attention))
    gen = torch.Generator(device=device).manual_seed(0)
    params = serve_loop.pack_params(M.init(cfg, gen), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device, dtype=torch.int32)

    if args.engine:
        ecfg = serve_loop.EngineConfig(
            max_batch=args.batch, page_size=args.page_size,
            num_pages=args.num_pages,
            max_seq_len=args.prompt_len + args.new_tokens,
            prefill_chunk=args.prefill_chunk, policy=args.policy,
            max_queue=args.max_queue, watchdog=args.watchdog, tp=args.tp,
            prefix_cache=args.prefix_cache, speculate=args.speculate,
            async_loop=args.async_loop,
            faults=args.inject_faults)
        eng = serve_loop.ServeEngine(params, cfg, ecfg, device=device)
        eng.warmup()
        for i in range(args.batch):
            eng.submit(tokens[i].tolist(), args.new_tokens, rid=i, arrival=i,
                       deadline_steps=args.deadline_steps)
        out = eng.run()
        eng.kv.check()
        s = eng.stats
        print(f"[launch.serve] engine(device={device}, precision="
              f"{s.precision}, policy={ecfg.policy}): {len(out)} requests; "
              f"decode {s.decode_tok_s:.1f} tok/s; occupancy "
              f"{s.mean_occupancy:.2f}; evictions {s.evictions}; ok "
              f"{s.completed_ok}; sample: {out[0].tokens[:8]}")
        if args.async_loop:
            print(f"[launch.serve] async loop: {s.lookahead_steps} "
                  f"lookahead dispatches; host gap {s.host_gap_s * 1e3:.1f}"
                  f"ms; overlap {s.overlap_frac:.2f}; d2h {s.d2h_bytes}B")
        return

    toks, stats = serve_loop.generate(params, cfg, tokens, args.new_tokens)
    print(f"[launch.serve] prefill {stats.prefill_s:.2f}s; decode "
          f"{stats.decode_tok_s:.1f} tok/s; sample: {toks[0][:8].tolist()}")


if __name__ == "__main__":
    main()
