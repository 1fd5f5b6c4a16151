"""The port's radix prefix cache and its copy-on-write step, held against
the JAX engine.

* ``attention.pool_copy_pages`` is bit-equal to JAX's on bf16 and int8
  pools, with chained pairs (a page that is both a destination and a
  later source in one call) and padding lanes (the port's spare page,
  JAX's dropped out-of-bounds dst);
* with ``prefix_cache=True`` the port's engine and the JAX engine, on the
  same weights (``convert.params_from_jax``) and traffic, emit the same
  streams, the same scheduler trace and the same prefix statistics, for
  the 2:4 and 4:6 families; cache-on streams equal cache-off;
* the partial-tail case (a resume point inside a shared page, so a write
  must copy the page first) and forced eviction with LRU reclaim of
  cached pages at ``num_pages=7``.

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
from repro.runtime import serve_loop as jserve

from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import linear as tlin
from repro_torch.models import attention as tattn
from repro_torch.runtime import serve_loop as tserve

ARCH = "h2o-danube-3-4b"
NARROW = dict(d_model=48, num_heads=4, num_kv_heads=2, head_dim=12,
              d_ff=96, num_layers=2)
ECFG = dict(max_batch=2, page_size=4, num_pages=24, max_seq_len=32,
            prefill_chunk=8)


@pytest.fixture(scope="module")
def jax_tree():
    cfg = dataclasses.replace(jreg.smoke_config(ARCH), **NARROW)
    return jax.tree_util.tree_map(np.asarray,
                                  JM.init(cfg, jax.random.PRNGKey(0)))


def _cfgs(pattern, recipe="int8"):
    sp = dict(pattern=pattern, mode="compressed", recipe=recipe,
              fused_attention=True)
    jcfg = dataclasses.replace(jreg.smoke_config(ARCH), **NARROW,
                               sparsity=jlin.SparsityConfig(
                                   use_pallas=False, **sp))
    tcfg = dataclasses.replace(treg.smoke_config(ARCH), **NARROW,
                               sparsity=tlin.SparsityConfig(**sp))
    return jcfg, tcfg


def _shared_prefix_prompts(seed, shared_len, suffix_lens, vocab=128):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=shared_len).tolist()
    return [shared + rng.integers(0, vocab, size=k).tolist()
            for k in suffix_lens]


def _serve(eng, prompts, max_new, arrivals):
    for i, p in enumerate(prompts):
        eng.submit(p, max_new, rid=i, arrival=arrivals[i])
    out = eng.run()
    eng.kv.check()
    return {i: tuple(c.tokens) for i, c in out.items()}


def _prefix_stats(eng):
    s = eng.stats
    return (s.prefix_hit_tokens, s.prefill_chunks_skipped, s.cow_copies,
            s.cached_page_evictions, s.evictions, s.prefill_tokens,
            s.recompute_tokens, s.decode_tokens)


def _both(jax_tree, pattern, prompts, max_new, ecfg, arrivals):
    """(port cache-off streams, port cache-on engine + streams, JAX
    cache-on engine + streams) on the same weights and traffic."""
    jcfg, tcfg = _cfgs(pattern)
    on = dict(ecfg, prefix_cache=True)
    jeng = jserve.ServeEngine(jserve.pack_params(jax_tree, jcfg), jcfg,
                              jserve.EngineConfig(**on))
    want = _serve(jeng, prompts, max_new, arrivals)
    params = tserve.pack_params(params_from_jax(jax_tree, tcfg, device="cpu"),
                                tcfg)
    off = _serve(tserve.ServeEngine(params, tcfg, tserve.EngineConfig(**ecfg),
                                    device="cpu"), prompts, max_new, arrivals)
    teng = tserve.ServeEngine(params, tcfg, tserve.EngineConfig(**on),
                              device="cpu")
    teng.warmup()  # writes nothing: the streams below are unaffected
    got = _serve(teng, prompts, max_new, arrivals)
    return off, (teng, got), (jeng, want)


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_pool_copy_pages_matches_jax(kind):
    num_pages, ps, kvh, hd = 8, 4, 2, 8
    rng = np.random.default_rng(11)
    spec = tattn.AttnSpec(d_model=16, num_heads=2, num_kv_heads=kvh,
                          head_dim=hd)
    pool = tattn.make_paged_pool(spec, num_pages, ps, getattr(torch, kind),
                                 device="cpu")
    for leaf in pool.values():  # distinct content in every page
        leaf.copy_(torch.from_numpy(rng.integers(-127, 128, leaf.shape,
                                                 dtype=np.int8))
                   if leaf.dtype == torch.int8 else
                   torch.from_numpy(rng.standard_normal(leaf.shape)).to(
                       leaf.dtype))
    # 1 -> 2 and 2 -> 5 chain through page 2 (its old content lands in
    # 5); 6 -> 0; two padding lanes
    src = np.array([1, 2, 6, 0, 3], np.int32)
    dst = np.array([2, 5, 0, num_pages, num_pages], np.int32)
    before = {n: t.clone() for n, t in pool.items()}
    jpool = {n: jnp.asarray(np.asarray(t[None, :num_pages].float()).astype(
        jnp.bfloat16) if t.dtype == torch.bfloat16
        else t[None, :num_pages].numpy()) for n, t in pool.items()}
    want = jattn.pool_copy_pages(jpool, jnp.asarray(src), jnp.asarray(dst))
    tattn.pool_copy_pages(pool, torch.from_numpy(src), torch.from_numpy(dst))
    for name, leaf in pool.items():
        real = leaf[:num_pages]
        jw = to_torch(np.asarray(want[name])[0], device="cpu")
        assert real.dtype == jw.dtype and torch.equal(real, jw), name
        assert torch.equal(real[5], before[name][2]), name  # read first
        assert torch.equal(real[2], before[name][1]), name
        for page in (1, 3, 4, 6, 7):
            assert torch.equal(real[page], before[name][page]), (name, page)


@pytest.mark.parametrize("pattern", [(2, 4), (4, 6)])
def test_prefix_cache_engine_matches_jax(jax_tree, pattern):
    prompts = _shared_prefix_prompts(pattern[1], 8, (3, 5, 8))
    off, (teng, got), (jeng, want) = _both(jax_tree, pattern, prompts, 4,
                                           ECFG, [0, 4, 8])
    assert got == want
    assert got == off, "cache-on diverged from cache-off"
    assert teng.sched.trace == jeng.sched.trace
    assert _prefix_stats(teng) == _prefix_stats(jeng)
    assert teng.stats.prefix_hit_tokens > 0
    assert teng.stats.prefill_chunks_skipped > 0
    assert teng.stats.prefix_hit_rate == jeng.stats.prefix_hit_rate > 0
    assert any("hit=" in t for t in teng.sched.trace)


def test_prefix_cache_partial_tail_cow(jax_tree):
    # identical full-page prompts with overlapping residency: the second
    # admission resumes inside the shared page, which must be copied
    prompts = _shared_prefix_prompts(0, 8, (0, 0))
    off, (teng, got), (jeng, want) = _both(jax_tree, (6, 8), prompts, 6,
                                           ECFG, [0, 4])
    assert got == want == off
    assert teng.sched.trace == jeng.sched.trace
    assert _prefix_stats(teng) == _prefix_stats(jeng)
    assert teng.stats.cow_copies > 0, "the partial tail must copy-on-write"
    assert teng.stats.prefix_hit_tokens == 7  # 8 cached, capped at len-1


def test_prefix_cache_forced_eviction(jax_tree):
    prompts = _shared_prefix_prompts(1, 8, (2, 4, 1))
    ecfg = dict(max_batch=3, page_size=4, num_pages=7, max_seq_len=24,
                prefill_chunk=8)
    off, (teng, got), (jeng, want) = _both(jax_tree, (6, 8), prompts, 8,
                                           ecfg, [0, 1, 2])
    assert got == want == off
    assert teng.sched.trace == jeng.sched.trace
    assert _prefix_stats(teng) == _prefix_stats(jeng)
    assert teng.stats.evictions > 0, "test needs page pressure"
    assert teng.stats.prefix_hit_tokens > 0
    assert teng.kv.pool.num_reclaimable == ecfg["num_pages"]
