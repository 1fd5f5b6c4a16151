"""The port's speculative decoding held against the JAX engine.

* ``runtime/draft.py`` (the port's copy) proposes and accepts exactly
  what ``repro.runtime.draft`` does, on seeded contexts;
* the multi-lane ``attention._decode_sdpa`` (JAX's ``_verify_sdpa``) and
  ``attention.paged_verify_step`` agree with JAX's on the same inputs
  within fp32 rounding (max abs error ``TOL`` = 2e-5 on O(1) outputs,
  fp32 weights and pools), through both the gather oracle and the fused
  kernel's plain version; lane i equals a one-lane call at kv_len + i
  bit for bit;
* with ``speculate=K`` the port's engine and the JAX engine, on the same
  weights (``convert.params_from_jax``) and traffic, emit the same
  streams, scheduler trace and draft/accept statistics at K in {1, 3},
  int8, compressed and slided; spec-on streams equal spec-off;
* random drafts that all reject, and an eos inside an accepted window,
  keep spec-on equal to spec-off;
* every paged attention call but a prefill chunk's keeps the kernel's
  ``row_exact`` (a verify row on the decode instance).

Smoke width (d_model 48, 2 layers, vocab 128) on the CPU, where the steps
run eagerly through the kernels' plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import linear as jlin
from repro.models import attention as jattn, model as JM
from repro.runtime import draft as jdraft, serve_loop as jserve

from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.core import linear as tlin
from repro_torch.models import attention as tattn
from repro_torch.runtime import draft as tdraft, serve_loop as tserve

ARCH = "h2o-danube-3-4b"
NARROW = dict(d_model=48, num_heads=4, num_kv_heads=2, head_dim=12,
              d_ff=96, num_layers=2)
ECFG = dict(max_batch=2, page_size=4, num_pages=24, max_seq_len=48,
            prefill_chunk=8)
TOL = 2e-5


@pytest.fixture(scope="module")
def jax_tree():
    cfg = dataclasses.replace(jreg.smoke_config(ARCH), **NARROW)
    return jax.tree_util.tree_map(np.asarray,
                                  JM.init(cfg, jax.random.PRNGKey(0)))


def _cfgs(mode, recipe):
    sp = dict(pattern=(6, 8), mode=mode, recipe=recipe, fused_attention=True)
    jcfg = dataclasses.replace(jreg.smoke_config(ARCH), **NARROW,
                               sparsity=jlin.SparsityConfig(
                                   use_pallas=False, **sp))
    tcfg = dataclasses.replace(treg.smoke_config(ARCH), **NARROW,
                               sparsity=tlin.SparsityConfig(**sp))
    return jcfg, tcfg


def _spec_prompts(n=3, seed=0, vocab=128):
    """A seeded phrase repeated: n-gram drafts find matches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        chunk = rng.integers(0, vocab, size=int(rng.integers(4, 9))).tolist()
        out.append(chunk * 3)
    return out


def _serve(eng, prompts, max_new, eos_id=None):
    for i, p in enumerate(prompts):
        eng.submit(p, max_new, rid=i, arrival=i, eos_id=eos_id)
    out = eng.run(on_step=lambda e, k: e.kv.check())
    eng.kv.check()
    assert eng.kv.pool.num_reclaimable == eng.ecfg.num_pages
    return {i: tuple(c.tokens) for i, c in out.items()}


def _spec_stats(eng):
    s = eng.stats
    return (s.verify_steps, s.draft_tokens, s.accepted_tokens,
            s.decode_tokens, s.decode_steps)


def _engines(jax_tree, mode, recipe, ecfg):
    jcfg, tcfg = _cfgs(mode, recipe)
    jp = jserve.pack_params(jax_tree, jcfg)
    tp = tserve.pack_params(params_from_jax(jax_tree, tcfg, device="cpu"),
                            tcfg)
    return (lambda **kw: jserve.ServeEngine(jp, jcfg, jserve.EngineConfig(
                **ecfg, **kw)),
            lambda **kw: tserve.ServeEngine(tp, tcfg, tserve.EngineConfig(
                **ecfg, **kw), device="cpu"))


# ---------------------------------------------------------- draft.py copy
@pytest.mark.parametrize("seed", range(4))
def test_draft_copy_proposes_and_accepts_like_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        ctx = rng.integers(0, 4, size=int(rng.integers(0, 30))).tolist()
        k = int(rng.integers(0, 6))
        for max_ngram in (2, 3):
            assert tdraft.NgramDraftSource(max_ngram).propose(ctx, k) == \
                jdraft.NgramDraftSource(max_ngram).propose(ctx, k)
        for name, kw in (("ngram", {}),
                         ("random", {"seed": seed, "vocab_size": 64})):
            assert tdraft.make_draft_source(name, **kw).propose(ctx, k) == \
                jdraft.make_draft_source(name, **kw).propose(ctx, k)
        draft = rng.integers(0, 3, size=k).tolist()
        argmax = rng.integers(0, 3, size=k + 1).tolist()
        assert tdraft.accept_drafts(draft, argmax) == \
            jdraft.accept_drafts(draft, argmax)
    assert sorted(tdraft.DRAFT_SOURCES) == sorted(jdraft.DRAFT_SOURCES)


# ------------------------------------------------------- the verify math
@pytest.mark.parametrize("window", [None, 5])
def test_verify_sdpa_matches_jax(window):
    """The port's multi-lane ``_decode_sdpa`` against JAX's
    ``_verify_sdpa``, and at one lane against JAX's ``_decode_sdpa``."""
    rng = np.random.default_rng(1)
    b, c, h, kvh, hd, s = 3, 4, 4, 2, 12, 20
    spec = tattn.AttnSpec(d_model=48, num_heads=h, num_kv_heads=kvh,
                          head_dim=hd, sliding_window=window)
    jspec = jattn.AttnSpec(d_model=48, num_heads=h, num_kv_heads=kvh,
                           head_dim=hd, sliding_window=window)
    q = rng.standard_normal((b, c, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    kv_len = np.array([1, 9, 16], np.int32)
    jq, jk, jv, jl = map(jnp.asarray, (q, k, v, kv_len))
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, kv_len))
    for fn, lanes in ((jattn._verify_sdpa, c), (jattn._decode_sdpa, 1)):
        want = np.asarray(fn(jspec, jq[:, :lanes], jk, jv, jl))
        got = tattn._decode_sdpa(spec, tq[:, :lanes], tk, tv, tl)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # lane i sees what a one-lane call at kv_len + i sees, bit for bit
    full = tattn._decode_sdpa(spec, tq, tk, tv, tl)
    for i in range(c):
        assert torch.equal(full[:, i:i + 1], tattn._decode_sdpa(
            spec, tq[:, i:i + 1], tk, tv, tl + i))


@pytest.mark.parametrize("fused", [False, True])
def test_paged_verify_step_matches_jax(fused):
    rng = np.random.default_rng(2)
    d, h, kvh, hd, ps, num_pages, maxp = 48, 4, 2, 12, 4, 14, 4
    b, c = 3, 3
    kw = dict(d_model=d, num_heads=h, num_kv_heads=kvh, head_dim=hd,
              sliding_window=6)
    spec, jspec = tattn.AttnSpec(**kw), jattn.AttnSpec(**kw)
    w = {n: (rng.standard_normal((o, i)) * i ** -0.5).astype(np.float32)
         for n, (o, i) in {"wq": (h * hd, d), "wk": (kvh * hd, d),
                           "wv": (kvh * hd, d), "wo": (d, h * hd)}.items()}
    x = rng.standard_normal((b, c, d)).astype(np.float32)
    pool = {n: rng.standard_normal((num_pages, ps, kvh, hd)).astype(
        np.float32) for n in ("k", "v")}
    table = rng.permutation(num_pages)[:b * maxp].reshape(b, maxp).astype(
        np.int32)
    kv_len = np.array([5, 0, 9], np.int32)     # pre-step written lengths
    real_len = np.array([3, 2, 1], np.int32)   # a pad lane, two pad lanes
    active = np.array([True, False, True])     # slot 1's writes dropped
    jsp = jlin.SparsityConfig(fused_attention=fused, use_pallas=False)
    jout, jpool = jattn.paged_verify_step(
        {n: {"w": jnp.asarray(a)} for n, a in w.items()}, jspec,
        jnp.asarray(x), jsp, {n: jnp.asarray(a) for n, a in pool.items()},
        jnp.asarray(table), jnp.asarray(kv_len), jnp.asarray(real_len),
        jnp.asarray(active), ps)
    tpool = tattn.make_paged_pool(spec, num_pages, ps, torch.float32,
                                  device="cpu")
    for n, a in pool.items():
        tpool[n][:num_pages] = torch.from_numpy(a)
    tout, _ = tattn.paged_verify_step(
        {n: {"w": torch.from_numpy(a)} for n, a in w.items()}, spec,
        torch.from_numpy(x), tlin.SparsityConfig(fused_attention=fused),
        tpool, *(torch.from_numpy(a) for a in (table, kv_len, real_len,
                                                active)), ps)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=TOL)
    for n in ("k", "v"):
        got = tpool[n][:num_pages].numpy()
        np.testing.assert_allclose(got, np.asarray(jpool[n]), rtol=0,
                                   atol=TOL)
        # exactly the writable lanes' cells changed
        assert (np.abs(got - pool[n]).sum(axis=(2, 3)) > 0).sum() == 3 + 1


def test_only_the_prefill_chunk_clears_row_exact(jax_tree, monkeypatch):
    """On the card a verify row takes the paged-attention kernel's decode
    instance (``row_exact``), so it gives a decode row's bits; only the
    prefill chunk may take the tensor-core instance."""
    from repro_torch.kernels import ops as kops
    seen, orig = set(), kops.paged_attention

    def spy(q, *args, row_exact=True, **kw):
        seen.add((q.shape[1], row_exact))
        return orig(q, *args, row_exact=row_exact, **kw)

    monkeypatch.setattr(kops, "paged_attention", spy)
    _, tcfg = _cfgs("compressed", "int8")
    params = tserve.pack_params(params_from_jax(jax_tree, tcfg, device="cpu"),
                                tcfg)
    # warmup runs one prefill chunk, one decode and one verify step
    tserve.ServeEngine(params, tcfg, tserve.EngineConfig(**ECFG, speculate=3),
                       device="cpu").warmup()
    assert seen == {(ECFG["prefill_chunk"], False), (1, True), (4, True)}


# ----------------------------------------------------- engine vs the JAX
@pytest.mark.parametrize("speculate", [1, 3])
@pytest.mark.parametrize("mode", ["compressed", "slided"])
def test_spec_engine_matches_jax_engine(jax_tree, mode, speculate):
    jmake, tmake = _engines(jax_tree, mode, "int8", ECFG)
    prompts = _spec_prompts()
    jeng = jmake(speculate=speculate)
    want = _serve(jeng, prompts, 8)
    off = _serve(tmake(), prompts, 8)
    teng = tmake(speculate=speculate)
    teng.warmup()  # writes nothing: the streams below are unaffected
    got = _serve(teng, prompts, 8)
    assert got == want
    assert got == off, "spec-on diverged from spec-off"
    assert teng.sched.trace == jeng.sched.trace
    assert _spec_stats(teng) == _spec_stats(jeng)
    s = teng.stats
    assert s.verify_steps > 0 and s.draft_tokens > 0
    assert s.accepted_tokens > 0, "no draft accepted: traffic too random"
    assert s.acceptance_rate == jeng.stats.acceptance_rate
    # each token is decode output once, except each request's first
    assert s.decode_tokens == sum(len(t) for t in got.values()) - len(got)


@pytest.mark.parametrize("recipe", ["none", "fp8", "w4"])
def test_spec_on_equals_spec_off(jax_tree, recipe):
    _, tmake = _engines(jax_tree, "compressed", recipe, ECFG)
    prompts = _spec_prompts(seed=3)
    off = _serve(tmake(), prompts, 8)
    eng = tmake(speculate=3)
    assert _serve(eng, prompts, 8) == off
    assert eng.stats.verify_steps > 0 and eng.stats.draft_tokens > 0


def test_random_drafts_all_reject(jax_tree):
    jmake, tmake = _engines(jax_tree, "compressed", "int8", ECFG)
    prompts = _spec_prompts(n=2, seed=2)
    kw = dict(speculate=3, draft_source="random")
    jeng = jmake(**kw)
    want = _serve(jeng, prompts, 6)
    teng = tmake(**kw)
    got = _serve(teng, prompts, 6)
    assert got == want == _serve(tmake(), prompts, 6)
    assert _spec_stats(teng) == _spec_stats(jeng)
    assert teng.stats.draft_tokens > 0
    assert teng.stats.acceptance_rate <= 0.2  # garbage barely accepts


def test_eos_mid_stream(jax_tree):
    jmake, tmake = _engines(jax_tree, "compressed", "int8", ECFG)
    prompts = _spec_prompts(n=2, seed=4)
    eos = _serve(tmake(), prompts, 8)[0][3]  # a token the model emits
    off = _serve(tmake(), prompts, 8, eos_id=eos)
    jeng = jmake(speculate=3)
    want = _serve(jeng, prompts, 8, eos_id=eos)
    teng = tmake(speculate=3)
    got = _serve(teng, prompts, 8, eos_id=eos)
    assert got == want == off
    assert off[0][-1] == eos and len(off[0]) <= 4  # truncated at eos
    assert _spec_stats(teng) == _spec_stats(jeng)
