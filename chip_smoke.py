#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: ``python3 chip_smoke.py`` from the
root of a checkout, on a machine with one NVIDIA H100.

Phases (any failed check exits nonzero):
1. device and build: the card's name and power limit, then both CUDA
   kernels built from ``src/repro_torch/csrc`` (one nvcc each, together);
2. B1, the compressed-matmul kernel, against its plain version at every
   h2o-danube-3-4b projection shape x R in {1, 4, prefill_chunk} x
   recipes int8, w4 (bit-equal) and fp8, none (bf16; tolerance below);
3. B2, the paged-attention kernel, against its plain version at full
   width (H=32, KVH=8, hd=120, page 16): decode B=4 up to ~1000 tokens and
   a 128-lane prefill chunk, window off and shorter than kv_len, bf16 and
   int8 pools, fp32 queries and the main path's bf16 queries (tolerances
   below);
4. the engine: full 24-layer h2o-danube-3-4b, 6:8 compressed, int8
   recipe, bf16 activations and KV pages, fused paged attention, serving
   4 staggered requests; both kernels' launch counts must rise during
   ``run()``, every request must finish OK, the page accounting must
   balance, and each request's last-prefill logits must agree with the
   one-shot prefill on the same weights, within a fixed limit that two
   planted faults, read in the same run, must exceed;
5. a ``kernels`` JSON line, the card line, and the final result line.

It imports neither JAX nor the JAX package, and prints every table it
measures on standard output.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}  # dense tensor-core peaks
PREFILL_CHUNK = 128
SHAPES = [(3840, 3840), (960, 3840), (10240, 3840), (3840, 10240),
          (32000, 3840)]
# linears per decode step of the 24-layer model: wq+wo, wk+wv, gate+up,
# down per layer, and the lm_head once
STEP_COUNTS = {(3840, 3840): 48, (960, 3840): 48, (10240, 3840): 48,
               (3840, 10240): 24, (32000, 3840): 1}
# ||engine - one-shot|| / ||one-shot|| of the last-prefill logits: a sound
# engine read at most 0.0663 on the H100, the planted faults at least 0.47
# per request (PERF.md); the limit sits between, 3x above the former
LOGIT_RL2 = 0.2
B2_TOL = 1e-4                  # fp32 queries: max abs error, outputs O(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


class Timer:
    """Device time of one call, in ms, averaged over ``iters`` calls; the
    L2 cache is flushed before each call (the main path finds each weight
    cold), and the flush runs before the start event."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn, iters=10, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters


def bound(bytes_moved: float, ops: float, kind: str):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, ops / PEAK_OPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ----------------------------------------------------------------- phase 2
def phase_b1(torch, timer):
    from repro_torch.core import linear as sl
    from repro_torch.core.compressed import CompressedSlided, \
        decompress_original
    from repro_torch.kernels import ref, slide_matmul as smm

    log("== B1 compressed_matmul vs plain (bf16 out; int8/w4 bit-equal; "
        "fp8/none within 2 bf16 ulps of max|plain|) ==")
    log("recipe M K R | kernel_ms plain_ms library_ms bound_ms bound_by "
        "| max_abs_err")
    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = 0.0
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "bytes_s": 0.0, "ops_s": 0.0}
    for recipe in ("int8", "w4", "fp8", "none"):
        cfg = sl.SparsityConfig(pattern=(6, 8), mode="compressed",
                                recipe=recipe)
        rec = cfg.recipe
        for m, k in SHAPES:
            w = (torch.randn((m, k), generator=gen, device="cuda")
                 * k ** -0.5).to(torch.bfloat16)
            p = sl.prepare({"w": w}, cfg)
            c = CompressedSlided(p["values"], p["indices"], k, 6, 8, 2, 4,
                                 packed=rec.packed_weights)
            w_dense = decompress_original(c).to(torch.bfloat16)
            if rec.quantized:
                w_dense = (w_dense.float() * p["s_w"]).to(torch.bfloat16)
            for r in (1, 4, PREFILL_CHUNK):
                x = torch.randn((r, k), generator=gen,
                                device="cuda").to(torch.bfloat16)
                if rec.quantized:
                    qx = rec.quantize_act(x)
                    args = (qx.q, c.values, c.indices, qx.scale, p["s_w"])

                    def kern():
                        return smm.compressed_matmul_cuda(
                            *args, n_fam=4, packed=c.packed,
                            out_dtype=torch.bfloat16)

                    def plain():
                        return ref.compressed_matmul_dequant(
                            qx.q, qx.scale, c, p["s_w"], torch.bfloat16)
                    x_bytes = r * k * qx.q.element_size() + 4 * r
                else:
                    def kern():
                        return smm.compressed_matmul_cuda(
                            x, c.values, c.indices, None, None, n_fam=4,
                            out_dtype=torch.bfloat16)

                    def plain():
                        return ref.compressed_matmul_fp(x, c, torch.bfloat16)
                    x_bytes = r * k * 2

                def library():
                    return torch.matmul(x, w_dense.T)

                n0 = smm.launch_count()
                y, y_ref = kern(), plain()
                torch.cuda.synchronize()
                assert smm.launch_count() == n0 + 1
                err = (y.float() - y_ref.float()).abs().max().item()
                scale = y_ref.float().abs().max().item()
                if recipe in ("int8", "w4"):
                    assert torch.equal(y, y_ref), \
                        f"B1 {recipe} {m}x{k} R={r}: not bit-equal ({err})"
                else:
                    assert err <= 2 ** -7 * scale, \
                        f"B1 {recipe} {m}x{k} R={r}: err {err} > 2^-7*{scale}"
                max_err = max(max_err, err)
                t_k = timer(kern)
                t_p = timer(plain, iters=3, warmup=1)
                t_l = timer(library)
                w_bytes = (c.values.numel() * c.values.element_size()
                           + c.indices.numel()
                           + (4 * m if rec.quantized else 0))
                nbytes = w_bytes + x_bytes + r * m * 2
                ops = 2 * r * m * k * 0.75  # the 6:8 non-zero budget
                kind = "int8" if rec.quantized else "bf16"
                b_ms, b_by = bound(nbytes, ops, kind)
                log(f"{recipe} {m} {k} {r} | {t_k:.4f} {t_p:.4f} {t_l:.4f} "
                    f"{b_ms:.4f} {b_by} | {err:.3g}")
                if recipe == "int8" and r == 4:
                    n = STEP_COUNTS[(m, k)]
                    step["ms"] += n * t_k
                    step["plain_ms"] += n * t_p
                    step["library_ms"] += n * t_l
                    step["bytes_s"] += n * nbytes / HBM_BYTES_S
                    step["ops_s"] += n * ops / PEAK_OPS["int8"]
            del w, p, c, w_dense
    torch.cuda.empty_cache()
    step["bound_ms"] = max(step["bytes_s"], step["ops_s"]) * 1e3
    step["bound_by"] = ("bytes" if step["bytes_s"] >= step["ops_s"]
                        else "operations")
    log(f"B1 per decode step (int8, R=4, 169 linears): kernel "
        f"{step['ms']:.3f} ms, plain {step['plain_ms']:.3f} ms, library "
        f"{step['library_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms "
        f"({step['bound_by']})")
    return max_err, step


# ----------------------------------------------------------------- phase 3
def phase_b2(torch, timer):
    import torch.nn.functional as F
    from repro_torch.kernels import ref, paged_attention as pa

    log(f"== B2 paged_attention vs plain (fp32 q: max abs err <= {B2_TOL}; "
        "bf16 q, the main path's instance: within 2^-7 of max|plain|) ==")
    log("case pool window | kernel_ms plain_ms library_ms bound_ms bound_by "
        "| max_abs_err fp32 bf16")
    gen = torch.Generator(device="cuda").manual_seed(2)
    h, kvh, hd, ps, num_pages = 32, 8, 120, 16, 320
    max_err, main = 0.0, None
    cases = [("decode", [1000, 517, 77, 260], 1),
             ("prefill", [257], PREFILL_CHUNK)]
    for name, kv_len, lanes in cases:
        b = len(kv_len)
        maxp = -(-(max(kv_len) + lanes - 1) // ps) + 2
        perm = torch.randperm(num_pages - 1, generator=gen,
                              device="cuda") + 1
        table = torch.zeros((b, maxp), dtype=torch.int32, device="cuda")
        used = 0
        for i, n_tok in enumerate(kv_len):
            n = -(-(n_tok + lanes - 1) // ps)
            table[i, :n] = perm[used:used + n].to(torch.int32)
            used += n
        kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        for pool_kind in ("bf16", "int8"):
            shape = (num_pages, ps, kvh, hd)
            if pool_kind == "bf16":
                pool = {n_: torch.randn(shape, generator=gen,
                                        device="cuda").to(torch.bfloat16)
                        for n_ in ("k", "v")}
            else:
                pool = {n_: torch.randint(-127, 128, shape, generator=gen,
                                          device="cuda", dtype=torch.int8)
                        for n_ in ("k", "v")}
                for n_ in ("k_scale", "v_scale"):
                    pool[n_] = torch.rand((num_pages, ps, kvh, 1),
                                          generator=gen,
                                          device="cuda") * 0.02 + 1e-3
            for window in (None, 300):
                q = torch.randn((b, lanes, h, hd), generator=gen,
                                device="cuda")
                qb = q.to(torch.bfloat16)  # the main path's instance
                y = pa.paged_attention_cuda(q, pool, table, kvl, window)
                y_ref = ref.flash_paged(q, pool, table, kvl, window, 8)
                yb = pa.paged_attention_cuda(qb, pool, table, kvl, window)
                yb_ref = ref.flash_paged(qb, pool, table, kvl, window, 8)
                torch.cuda.synchronize()
                err32 = (y - y_ref).abs().max().item()
                assert err32 <= B2_TOL, \
                    f"B2 {name} {pool_kind} {window} fp32: {err32}"
                err = (yb.float() - yb_ref.float()).abs().max().item()
                scale = yb_ref.float().abs().max().item()
                assert err <= 2 ** -7 * scale, \
                    f"B2 {name} {pool_kind} {window} bf16: {err} > " \
                    f"2^-7*{scale}"
                max_err = max(max_err, err32, err)
                t_k = timer(lambda: pa.paged_attention_cuda(
                    qb, pool, table, kvl, window))
                t_p = timer(lambda: ref.flash_paged(qb, pool, table, kvl,
                                                    window, 8),
                            iters=3, warmup=1)
                # yardstick: SDPA over K/V gathered beforehand (bf16)
                kg = pool["k"][table.long()].reshape(b, -1, kvh, hd)
                vg = pool["v"][table.long()].reshape(b, -1, kvh, hd)
                if pool_kind == "int8":
                    kg = kg.float() * pool["k_scale"][table.long()].reshape(
                        b, -1, kvh, 1)
                    vg = vg.float() * pool["v_scale"][table.long()].reshape(
                        b, -1, kvh, 1)
                kg = kg.to(torch.bfloat16).transpose(1, 2).contiguous()
                vg = vg.to(torch.bfloat16).transpose(1, 2).contiguous()
                pos = torch.arange(kg.shape[2], device="cuda")
                row_len = kvl[:, None] + torch.arange(lanes, device="cuda")
                mask = pos[None, None, :] < row_len[:, :, None]
                if window is not None:
                    mask &= pos[None, None, :] >= row_len[:, :, None] - window
                mask = mask[:, None]
                qt = qb.transpose(1, 2)
                t_l = timer(lambda: F.scaled_dot_product_attention(
                    qt, kg, vg, attn_mask=mask, enable_gqa=True))
                seen = 0
                for n_tok in kv_len:
                    for lane in range(lanes):
                        rl = n_tok + lane
                        seen += rl - max(0, rl - window) if window else rl
                # K/V tokens some row needs: [lo, kv_len + lanes - 1)
                toks = sum(n_tok + lanes - 1
                           - (max(0, n_tok - window) if window else 0)
                           for n_tok in kv_len)
                itemsize = pool["k"].element_size()
                nbytes = (2 * toks * kvh * hd * itemsize
                          + (2 * toks * kvh * 4
                             if pool_kind == "int8" else 0)
                          + 2 * q.numel() * 2 + table.numel() * 4 + 4 * b)
                ops = 4 * seen * (h // kvh) * kvh * hd
                b_ms, b_by = bound(nbytes, ops, "bf16")
                log(f"{name} {pool_kind} {window} | {t_k:.4f} {t_p:.4f} "
                    f"{t_l:.4f} {b_ms:.4f} {b_by} | {err32:.3g} {err:.3g}")
                if name == "decode" and pool_kind == "bf16" and window is None:
                    main = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                            "bound_ms": b_ms, "bound_by": b_by}
    torch.cuda.empty_cache()
    # per decode step: the model's 24 attention layers at this shape
    step = {k_: (24 * v if k_.endswith("ms") else v) for k_, v in main.items()}
    log(f"B2 per decode step (24 layers, B=4, bf16 pool): kernel "
        f"{step['ms']:.3f} ms, plain {step['plain_ms']:.3f} ms, library "
        f"{step['library_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms")
    return max_err, step


# ----------------------------------------------------------------- phase 4
def phase_engine(torch, card):
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.core.linear import SparsityConfig
    from repro_torch.kernels import ops as kops, paged_attention as pa, \
        slide_matmul as smm
    from repro_torch.models import model as M
    from repro_torch.runtime import serve_loop

    log("== engine: h2o-danube-3-4b 24L d3840, 6:8 compressed int8, bf16, "
        "fused attention ==")
    cfg = dataclasses.replace(
        registry.get("h2o-danube-3-4b"),
        sparsity=SparsityConfig(pattern=(6, 8), mode="compressed",
                                recipe="int8", fused_attention=True))
    assert cfg.dtype == "bfloat16" and cfg.kv_cache_dtype == "bfloat16"
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = serve_loop.pack_params(M.init(cfg, gen), cfg)
    torch.cuda.synchronize()
    packed = sum(t.numel() * t.element_size()
                 for u in params["units"] for lp in u.values()
                 for blk in ("mixer", "ffn") for lin in lp[blk].values()
                 for t in lin.values()) + sum(
        t.numel() * t.element_size() for t in params["lm_head"].values())
    log(f"init + pack: {time.time() - t0:.1f} s; compressed linears "
        f"{packed / 1e9:.2f} GB; device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")

    plens, new_tokens = [53, 117, 211, 298], 32
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device="cuda").tolist() for n in plens]
    ecfg = serve_loop.EngineConfig(max_batch=4, page_size=16, num_pages=128,
                                   max_seq_len=max(plens) + new_tokens,
                                   prefill_chunk=PREFILL_CHUNK)
    eng = serve_loop.ServeEngine(params, cfg, ecfg, device="cuda")
    log(f"warmup: {eng.warmup():.2f} s")
    for i, p in enumerate(prompts):
        eng.submit(p, new_tokens, rid=i, arrival=2 * i)
    smm.reset_counts()
    pa.reset_counts()
    out = eng.run()
    launches = {"compressed_matmul": smm.launch_count(),
                "paged_attention": pa.launch_count()}
    s = eng.stats
    log(f"run: {s.steps} steps, {s.decode_steps} decode steps, "
        f"{s.decode_tokens} decode tokens in {s.wall_s:.3f} s; launches "
        f"{launches}; B1 weight tiles decompressed "
        f"{smm.decompress_count()}")
    assert all(launches[k] > 0 for k in launches), launches
    assert sorted(out) == list(range(len(prompts)))
    assert all(c.ok and len(c.tokens) == new_tokens for c in out.values())
    eng.kv.check()

    log(f"decode throughput {s.decode_tok_s:.2f} tok/s (decode tokens over "
        f"run wall time incl. prefill) on {card}")

    # Gate of the last-prefill logits: the relative L2 distance
    # ||engine - one-shot|| / ||one-shot|| of each request, at the fixed
    # limit LOGIT_RL2.  The engine (paged kernel, fp32 softmax, 128-token
    # chunks) and the one-shot prefill (plain chunked SDPA in bf16) round
    # differently, and int8 activation quantization turns a rounding
    # difference into a whole step in the next linear, so a sound engine
    # sits above 0 (0.057-0.066).  Two planted faults are read in the same run
    # and must land above the limit, or the gate could not tell them from
    # that noise: "short", the engine re-run with every query row missing
    # its newest key (kv_len one short at the paged-attention call), and
    # "dropped", the engine's logits against the one-shot prefill of the
    # prompt without its last token.
    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    orig = kops.paged_attention

    def short_by_one(q, pool, page_table, kv_len, **kw):
        return orig(q, pool, page_table, kv_len - 1, **kw)

    kops.paged_attention = short_by_one
    try:
        bad = serve_loop.ServeEngine(params, cfg, ecfg, device="cuda")
        for i, p in enumerate(prompts):
            bad.submit(p, 1, rid=i, arrival=2 * i)
        bad.run()
    finally:
        kops.paged_attention = orig

    same, total = 0, 0
    read = {"sound": [], "short": [], "dropped": []}
    for i, p in enumerate(prompts):
        tok = torch.tensor([p], dtype=torch.int32, device="cuda")
        ref = M.prefill(params, cfg, tok)[0][0].float()
        got = eng.first_logits[i].float()
        read["sound"].append(rel_l2(got, ref))
        read["short"].append(rel_l2(bad.first_logits[i].float(), ref))
        read["dropped"].append(rel_l2(
            got, M.prefill(params, cfg, tok[:, :-1])[0][0].float()))
        ref_toks, _ = serve_loop.generate(params, cfg, tok, new_tokens)
        same += sum(int(a == b) for a, b in zip(ref_toks[0].tolist(),
                                                out[i].tokens))
        total += new_tokens
        log(f"request {i}: prompt {len(p)}; last-prefill relative L2 vs "
            f"one-shot: sound {read['sound'][-1]:.5f}, short "
            f"{read['short'][-1]:.5f}, dropped {read['dropped'][-1]:.5f}; "
            f"max|diff|/std {((got - ref).abs().max() / ref.std()).item():.4f}"
            f"; argmax {int(got.argmax())} / {int(ref.argmax())}")
    log(f"identical tokens vs one-shot generate: {same}/{total} "
        f"({same / total:.3f})")
    worst = {k: max(v) for k, v in read.items()}
    log(f"last-prefill logits, worst relative L2: sound {worst['sound']:.5f}"
        f", planted faults short {worst['short']:.5f} and dropped "
        f"{worst['dropped']:.5f}; limit {LOGIT_RL2}")
    assert worst["sound"] <= LOGIT_RL2, \
        f"engine logits off by {worst['sound']} > {LOGIT_RL2}"
    for fault in ("short", "dropped"):
        assert worst[fault] > LOGIT_RL2, \
            f"planted fault {fault} ({worst[fault]}) passes the gate"
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs the card",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2

    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    libs = _build.build(verbose=True)
    log(f"build: {time.time() - t0:.1f} s -> "
        f"{', '.join(p.name for p in libs.values())}")
    for name, lib in libs.items():
        logf = lib.with_suffix(".log")
        text = logf.read_text() if logf.exists() else ""
        regs = [int(w) for line in text.splitlines() if "Used" in line
                for a, w in zip(line.split(), line.split()[1:])
                if a == "Used"]
        spills = [line.strip() for line in text.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        log(f"ptxas {name}: {len(regs)} kernels, max {max(regs, default=0)} "
            f"registers, {len(spills)} with spills")

    timer = Timer(torch)
    b1_err, b1 = phase_b1(torch, timer)
    b2_err, b2 = phase_b2(torch, timer)
    del timer
    torch.cuda.empty_cache()
    launches = phase_engine(torch, card)

    kernels = [
        {"name": "compressed_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/compressed_matmul.cu",
         "replaces": "src/repro/kernels/slide_matmul.py:155",
         "launches": launches["compressed_matmul"], "max_abs_err": b1_err,
         "ms": b1["ms"], "kernel_ms": b1["ms"], "plain_ms": b1["plain_ms"],
         "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
         "library_ms": b1["library_ms"]},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:202",
         "launches": launches["paged_attention"], "max_abs_err": b2_err,
         "ms": b2["ms"], "kernel_ms": b2["ms"], "plain_ms": b2["plain_ms"],
         "bound_ms": b2["bound_ms"], "bound_by": b2["bound_by"],
         "library_ms": b2["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
