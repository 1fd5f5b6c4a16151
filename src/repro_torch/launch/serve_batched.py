"""Batched serving with SlideSparse-packed weights (port of
``examples/serve_batched.py``).

Run:  python -m repro_torch.launch.serve_batched [--pattern 6 8]
      python -m repro_torch.launch.serve_batched --engine --requests 4

Default mode serves the same prompts dense and (2N-2):2N-compressed
through the one-shot loop and reports throughput, token agreement and the
analytic speedup bound of the packed format.  ``--engine`` switches to
continuous-batching traffic: requests of different prompt lengths arrive
staggered, join the running decode batch, retire and free their KV pages,
and every stream is checked against the one-shot reference (an OK stream
exactly, a CANCELLED / TIMEOUT / FAILED one as a prefix, a REJECTED one
empty); the run exits nonzero on a divergence.  ``--shared-prefix N``
opens every request with one N-token system prompt for ``--prefix-cache``
to reuse; ``--speculate K`` verifies drafts of ``--draft`` in one
[B, K+1] step; ``--inject-faults SEED`` arms the fault injector and
``--cancel-frac F`` cancels a seeded share of the requests mid-flight;
``--async`` runs the overlapped loop; ``--tp N`` serves tensor-parallel
over N ranks (started here, or ``torchrun``'s) on the ``--dist-backend``
named, rank 0 printing and holding the streams to the one-shot
reference.  Runs on CUDA unless ``--device``
says otherwise; weights come from a seeded ``torch.Generator``.
``--arch`` picks the family (MoE and SSM stacks included), widened as
the JAX example widens it; an SSM block's ``wo`` is drawn too (``init``
keeps JAX's zeros, which make the block the identity).
"""
import argparse
import dataclasses
import sys

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.core.linear import SparsityConfig
from repro_torch.core.patterns import Pattern, SlideDecomposition, TWO_FOUR
from repro_torch.models import model as M
from repro_torch.runtime import faults as fl, serve_loop
from repro_torch.sharding import dist as tdist


def demo_model(arch, device):
    """``arch``'s smoke config widened as the JAX example widens it, and
    random weights from the seed-0 generator (returned too, for what the
    demo draws next)."""
    base = registry.smoke_config(arch)
    base = dataclasses.replace(base, d_model=256, num_heads=8, num_kv_heads=4,
                               head_dim=32, d_ff=512, vocab_size=4096,
                               num_layers=len(base.unit_pattern) * 2)
    gen = torch.Generator(device=device).manual_seed(0)
    # an SSM block's wo is drawn too: init's zeros make the block the
    # identity
    return base, M.draw_ssm_wo(M.init(base, gen), base, gen), gen


def engine_traffic(args, base, params):
    """The engine demo's packed model and traffic: (cfg, packed params,
    prompts, engine config)."""
    z, l = args.pattern
    if args.shared_prefix >= args.prompt_len:
        raise SystemExit(f"--shared-prefix {args.shared_prefix} must be < "
                         f"--prompt-len {args.prompt_len} (each prompt "
                         "needs at least one unique suffix token)")
    cfg = dataclasses.replace(base, sparsity=SparsityConfig(
        pattern=(z, l), mode="compressed", fuse_epilogue=args.fuse_epilogue,
        fused_attention=args.fused_attention))
    packed = serve_loop.pack_params(params, cfg)

    rng = np.random.default_rng(0)
    shared = rng.integers(0, base.vocab_size,
                          size=args.shared_prefix).tolist()
    lo = max(1, (args.prompt_len - args.shared_prefix) // 2)
    hi = max(lo + 1, args.prompt_len - args.shared_prefix + 1)
    prompts = [shared + rng.integers(0, base.vocab_size,
                                     size=int(rng.integers(lo, hi))).tolist()
               for _ in range(args.requests)]
    plan = None
    if args.inject_faults is not None:
        plan = fl.FaultPlan(seed=args.inject_faults, alloc_fail_rate=0.08,
                            step_error_rate=0.04)
    ecfg = serve_loop.EngineConfig(
        max_batch=min(args.batch, args.requests), page_size=8,
        num_pages=max(16, args.requests *
                      (args.prompt_len + args.new_tokens) // 8 + 8),
        max_seq_len=args.prompt_len + args.new_tokens,
        prefill_chunk=max(8, args.prompt_len // 2), tp=args.tp,
        prefix_cache=args.prefix_cache, policy=args.policy,
        watchdog=args.watchdog, faults=plan,
        speculate=args.speculate, draft_source=args.draft,
        async_loop=args.async_loop)
    return cfg, packed, prompts, ecfg


def run_engine(args, packed, cfg, ecfg, prompts, device):
    """Serve the demo's traffic (and its seeded cancellations) through one
    engine; returns (engine, completions, cancellation schedule)."""
    eng = serve_loop.ServeEngine(packed, cfg, ecfg, device=device)
    eng.warmup()
    for i, p in enumerate(prompts):
        eng.submit(p, args.new_tokens, rid=i, arrival=2 * i)

    # seeded cancellation schedule: cancel_frac of the rids, each at a
    # deterministic engine step
    cancel_at: dict[int, int] = {}
    if args.cancel_frac > 0:
        crng = np.random.default_rng(args.inject_faults or 0)
        victims = crng.choice(args.requests,
                              size=int(args.cancel_frac * args.requests),
                              replace=False)
        for r in victims:
            cancel_at[int(crng.integers(2, 12))] = int(r)

    def on_step(e, k):
        if k in cancel_at:
            e.cancel(cancel_at[k])

    out = eng.run(on_step=on_step if cancel_at else None)
    eng.kv.check()  # no leaked or aliased pages, faults or not
    if args.tp > 1:
        torch.distributed.destroy_process_group()
    return eng, out, cancel_at


def engine_demo(args, base, params, device, rank=0):
    """Continuous-batching traffic over the packed pipeline, every stream
    held to the one-shot reference on the same packed weights (by rank 0
    under ``--tp``; the other ranks serve and print nothing)."""
    cfg, packed, prompts, ecfg = engine_traffic(args, base, params)
    if rank:
        run_engine(args, packed, cfg, ecfg, prompts, device)
        return
    z, l = args.pattern
    plan = ecfg.faults
    print(f"=== SlideSparse {z}:{l} continuous-batching engine "
          f"({args.requests} staggered requests, device={device}, "
          f"policy={args.policy}, prefix_cache={args.prefix_cache}, "
          f"attention={'fused' if args.fused_attention else 'gather'}) ===")
    if plan is not None:
        print(f"fault injection armed: seed={plan.seed} "
              f"alloc_fail_rate={plan.alloc_fail_rate} "
              f"step_error_rate={plan.step_error_rate} "
              f"cancel_frac={args.cancel_frac} watchdog={args.watchdog}")
    eng, out, cancel_at = run_engine(args, packed, cfg, ecfg, prompts,
                                     device)
    s = eng.stats
    print(f"engine(tp={s.tp}): {s.steps} steps, decode "
          f"{s.decode_tok_s:.1f} tok/s, batch occupancy "
          f"{s.mean_occupancy:.2f}, evictions {s.evictions}")
    if args.async_loop:
        print(f"async loop: {s.lookahead_steps} lookahead dispatches, host "
              f"gap {s.host_gap_s * 1e3:.1f}ms, overlap "
              f"{s.overlap_frac:.2f}, d2h {s.d2h_bytes}B")
    if args.speculate > 0:
        print(f"speculative decode (K={args.speculate}, "
              f"source={args.draft}): {s.verify_steps} verify steps, "
              f"{s.accepted_tokens}/{s.draft_tokens} drafts accepted "
              f"(rate {s.acceptance_rate:.2f})")
    if plan is not None or cancel_at:
        print(f"lifecycle: ok={s.completed_ok} cancelled={s.cancelled} "
              f"timeouts={s.timeouts} rejected={s.rejected} "
              f"failed={s.failed} quarantined={s.quarantined}; "
              f"faults_injected={s.faults_injected} "
              f"(step_errors={s.step_errors}, "
              f"recovered_retries={s.step_retries}); "
              f"injector[{eng.injector.describe() if eng.injector else '-'}]")
    if args.prefix_cache:
        print(f"prefix cache: hit_rate {s.prefix_hit_rate:.2f}, "
              f"{s.prefix_hit_tokens} cached tokens, "
              f"{s.prefill_chunks_skipped} prefill chunks skipped, "
              f"{s.cow_copies} COW page copies")
        if args.shared_prefix >= 2 * ecfg.page_size and args.requests > 1 \
                and s.prefix_hit_tokens == 0:
            raise SystemExit("shared system prompt produced no prefix hits")

    mismatch = 0
    for i, p in enumerate(prompts):
        toks, _ = serve_loop.generate(
            packed, cfg, torch.tensor([p], dtype=torch.int32, device=device),
            args.new_tokens)
        ref = toks[0].tolist()
        comp = out[i]
        if comp.status == "REJECTED":
            ok = comp.tokens == []          # never executed
        elif comp.ok:
            ok = ref == comp.tokens         # unaffected: exact parity
        else:  # what was generated before the exit: a prefix
            ok = comp.tokens == ref[:len(comp.tokens)]
        mismatch += not ok
        print(f"  r{i}: prompt_len={len(p)} status={comp.status}"
              f"{'' if comp.ok else f'({comp.reason})'} "
              f"tokens={comp.tokens[:6]}... "
              f"parity_with_one_shot={'OK' if ok else 'MISMATCH'}")
    if mismatch:
        raise SystemExit(f"{mismatch} stream(s) diverged from the one-shot "
                         "reference")
    print("all engine streams match the one-shot reference "
          "(OK exact; non-OK prefix)")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--pattern", nargs=2, type=int, default=(6, 8))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--fuse-epilogue", action="store_true",
                    help="fuse the MLP SiLU into the matmul epilogue")
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching paged-KV engine demo")
    ap.add_argument("--requests", type=int, default=4,
                    help="engine mode: number of staggered requests")
    ap.add_argument("--tp", type=int, default=1,
                    help="engine mode: tensor-parallel ranks")
    ap.add_argument("--dist-backend", default="nccl",
                    choices=["nccl", "gloo"],
                    help="engine mode: torch.distributed backend of the "
                         "--tp ranks (nccl needs one device per rank)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="engine mode: radix prefix cache over ref-counted "
                         "copy-on-write pages")
    ap.add_argument("--policy", default="fcfs", choices=["fcfs", "priority"],
                    help="engine mode: scheduler admission/eviction policy")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="engine mode: open every request with the same "
                         "N-token system prompt")
    ap.add_argument("--inject-faults", type=int, default=None,
                    metavar="SEED",
                    help="engine mode: allocation failures and transient "
                         "step errors on SEED's schedule")
    ap.add_argument("--cancel-frac", type=float, default=0.0,
                    help="engine mode: cancel this fraction of requests "
                         "mid-flight on a seeded schedule")
    ap.add_argument("--watchdog", action="store_true",
                    help="engine mode: assert KV invariants after every "
                         "scheduler decision")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="engine mode: draft up to K tokens per sequence "
                         "and verify them in one [B, K+1] step")
    ap.add_argument("--draft", default="ngram", choices=["ngram", "random"],
                    help="engine mode: draft source for --speculate")
    ap.add_argument("--fused-attention", action="store_true",
                    help="engine mode: paged steps through the paged-"
                         "attention kernel instead of gather-then-SDPA")
    ap.add_argument("--async", dest="async_loop", action="store_true",
                    help="engine mode: overlapped host/device loop")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    rank = 0
    if args.tp > 1:
        if not args.engine:
            raise SystemExit("--tp requires --engine")
        joined = tdist.launcher_ranks(
            "repro_torch.launch.serve_batched",
            sys.argv[1:] if argv is None else list(argv), args.tp,
            args.dist_backend, args.device)
        if joined is None:  # the ranks ran, rank 0's output printed
            return
        rank, device = joined
    else:
        device = resolve_device(args.device)
    base, params, gen = demo_model(args.arch, device)
    if args.engine:
        return engine_demo(args, base, params, device, rank)
    tokens = torch.randint(0, base.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device, dtype=torch.int32)

    print(f"=== dense serving ({base.name} family, device={device}) ===")
    toks_d, stats_d = serve_loop.generate(params, base, tokens,
                                          args.new_tokens)
    print(f"prefill {stats_d.prefill_s:.2f}s  decode "
          f"{stats_d.decode_tok_s:.1f} tok/s")

    z, l = args.pattern
    cfg = dataclasses.replace(base, sparsity=SparsityConfig(
        pattern=(z, l), mode="compressed", fuse_epilogue=args.fuse_epilogue))
    packed = serve_loop.pack_params(params, cfg)
    print(f"=== SlideSparse {z}:{l} serving (packed + compressed) ===")
    toks_s, stats_s = serve_loop.generate(packed, cfg, tokens,
                                          args.new_tokens)
    print(f"prefill {stats_s.prefill_s:.2f}s  decode "
          f"{stats_s.decode_tok_s:.1f} tok/s")

    agree = (toks_d == toks_s).float().mean().item()
    dec = SlideDecomposition(Pattern(z, l), TWO_FOUR)
    print(f"\ntoken agreement dense vs {z}:{l}: {agree:.2f} (pruning "
          "changes the model: high for mild patterns, not exact)")
    print(f"analytic bounds: GPU sparse-tensor-core S_eff = "
          f"{float(dec.s_eff):.3f}x; decode weight traffic = "
          f"{float(dec.source.density):.3f}x of dense bytes (+2-bit meta)")


if __name__ == "__main__":
    main()
