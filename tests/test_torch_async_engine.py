"""The port's overlapped engine loop (``async_loop``) held to its
synchronous loop and to the JAX engine's overlapped loop.

The loop is a scheduling transformation (DESIGN.md §15): it changes when
the host applies a step's tokens and what crosses to the host, never what
is computed.  So the contract is equality:

* async-on streams and scheduler decision traces equal async-off, for
  both sparse modes and the ``none`` and ``int8`` recipes, and the fast
  path (a lookahead decode fed by the previous step's device-resident
  ids) fires;
* the port's async streams equal the JAX engine's with
  ``async_loop=True`` on the same weights (``convert.params_from_jax``)
  and traffic;
* recompute-preemption and a cancel between dispatch and apply keep the
  synchronous loop's streams and trace;
* the decode fast path fetches a ``[max_batch]`` int32 array per step and
  nothing float, and ``d2h_bytes`` counts exactly what was fetched.

Smoke width (d_model 48, 2 layers, vocab 128) on the CPU, where the
engine runs its steps eagerly through the kernels' plain versions.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.core import linear as jlin
from repro.models import model as JM
from repro.runtime import serve_loop as jserve

from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.core import linear as tlin
from repro_torch.runtime import serve_loop as tserve

ARCH = "h2o-danube-3-4b"
NARROW = dict(d_model=48, num_heads=4, num_kv_heads=2, head_dim=12,
              num_layers=2)
ECFG = dict(max_batch=3, page_size=4, num_pages=32, max_seq_len=32,
            prefill_chunk=6)


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


def _port_params(jax_tree, tcfg):
    return tserve.pack_params(params_from_jax(jax_tree, tcfg, device="cpu"),
                              tcfg)


def _prompts(seed, lens, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=k).tolist() for k in lens]


def _serve(eng, prompts, max_new, on_step=None):
    eng.warmup()
    for i, p in enumerate(prompts):
        eng.submit(p, max_new, rid=i, arrival=i % 3)
    out = eng.run(on_step=on_step)
    eng.kv.check()
    return {i: tuple(c.tokens) for i, c in out.items()}


def _port(params, tcfg, async_loop, **over):
    ecfg = tserve.EngineConfig(**{**ECFG, **over, "async_loop": async_loop})
    return tserve.ServeEngine(params, tcfg, ecfg, device="cpu")


@pytest.mark.parametrize("recipe", ["none", "int8"])
@pytest.mark.parametrize("mode", ["compressed", "slided"])
def test_async_parity_streams_and_traces(jax_tree, mode, recipe):
    jcfg, tcfg = _cfgs(mode, recipe)
    params = _port_params(jax_tree, tcfg)
    prompts = _prompts(11, (5, 9, 12))
    e_sync, e_async = _port(params, tcfg, False), _port(params, tcfg, True)
    o_sync = _serve(e_sync, prompts, 8)
    o_async = _serve(e_async, prompts, 8)
    assert sorted(o_async) == [0, 1, 2]
    assert all(len(t) == 8 for t in o_async.values())
    assert o_async == o_sync
    assert e_async.sched.trace == e_sync.sched.trace
    # stable tail batches must take the fast path, or this test would
    # quietly compare the synchronous loop with itself
    assert e_async.stats.lookahead_steps > 0
    assert e_sync.stats.lookahead_steps == 0
    assert 0.0 <= e_async.stats.overlap_frac <= 1.0

    jeng = jserve.ServeEngine(jserve.pack_params(jax_tree, jcfg), jcfg,
                              jserve.EngineConfig(**ECFG, async_loop=True))
    jeng.warmup()
    for i, p in enumerate(prompts):
        jeng.submit(p, 8, rid=i, arrival=i % 3)
    want = {i: tuple(c.tokens) for i, c in jeng.run().items()}
    assert o_async == want
    assert e_async.sched.trace == jeng.sched.trace
    assert e_async.stats.lookahead_steps == jeng.stats.lookahead_steps


def test_async_parity_under_eviction_pressure(jax_tree):
    """Recompute-preemption voids the lookahead (the scheduler bails
    before evicting); streams and trace still equal the sync loop's."""
    _, tcfg = _cfgs("compressed", "none")
    params = _port_params(jax_tree, tcfg)
    prompts = _prompts(7, (9, 13, 11))
    over = dict(num_pages=7, max_seq_len=28, prefill_chunk=8)
    e_sync = _port(params, tcfg, False, **over)
    e_async = _port(params, tcfg, True, **over)
    o_sync = _serve(e_sync, prompts, 8)
    o_async = _serve(e_async, prompts, 8)
    assert e_sync.stats.evictions > 0, "pressure did not force an eviction"
    assert o_async == o_sync
    assert e_async.sched.trace == e_sync.sched.trace


def test_async_cancel_between_dispatch_and_apply(jax_tree):
    """A cancel while a decode step is in flight lands the pending tokens
    first: the cancelled stream keeps its applied prefix and the
    survivors equal a sync run with the same cancel schedule."""
    _, tcfg = _cfgs("compressed", "none")
    params = _port_params(jax_tree, tcfg)
    prompts = _prompts(3, (6, 6, 6))
    seen = {}

    def run(async_loop):
        eng = _port(params, tcfg, async_loop)
        eng.warmup()
        for i, p in enumerate(prompts):
            eng.submit(p, 10, rid=i, arrival=0)

        def hook(e, step):
            if step == 8:
                seen[async_loop] = e._pending is not None
                e.cancel(1)

        out = eng.run(on_step=hook)
        eng.kv.check()
        return {i: tuple(c.tokens) for i, c in out.items()}, eng

    o_sync, e_sync = run(False)
    o_async, e_async = run(True)
    assert seen == {False: False, True: True}, "no step was in flight"
    assert o_async == o_sync
    assert e_async.sched.trace == e_sync.sched.trace
    assert e_async.stats.cancelled == e_sync.stats.cancelled == 1
    assert e_async.completions[1].status == "CANCELLED"


def test_decode_fast_path_d2h_payload_is_batch_int32(jax_tree):
    """With on-device sampling each decode step fetches a [max_batch]
    int32 array and nothing float, and ``d2h_bytes`` is the sum of what
    was fetched; the host-sample engine fetches [B, V] float32 logits."""
    _, tcfg = _cfgs("compressed", "none")
    params = _port_params(jax_tree, tcfg)
    prompts = _prompts(11, (6, 6, 6))
    bmax, new = ECFG["max_batch"], 10

    def run(device_sample, async_loop):
        eng = _port(params, tcfg, async_loop, device_sample=device_sample)
        fetches = []
        orig = eng._fetch

        def spy(handle):
            arr = orig(handle)
            fetches.append((arr.shape, arr.dtype))
            return arr

        eng._fetch = spy
        for i, p in enumerate(prompts):
            eng.submit(p, new, rid=i, arrival=0)
        out = eng.run()
        return {i: tuple(c.tokens) for i, c in out.items()}, eng, fetches

    o_async, e_async, f_async = run(True, True)
    o_sync, e_sync, f_sync = run(False, False)
    assert o_async == o_sync
    assert all(np.issubdtype(dt, np.int32) for _, dt in f_async), f_async
    decode = [s for s, _ in f_async if s == (bmax,)]
    assert len(decode) >= new - 1, "decode id fetches missing"
    assert e_async.stats.d2h_bytes == sum(
        int(np.prod(s)) * np.dtype(dt).itemsize for s, dt in f_async)
    assert e_async.stats.d2h_bytes == 4 * (len(decode) * bmax
                                           + len(f_async) - len(decode))
    assert any(s == (bmax, tcfg.vocab_size) and dt == np.float32
               for s, dt in f_sync), f_sync
    assert e_sync.stats.d2h_bytes > 16 * e_async.stats.d2h_bytes
