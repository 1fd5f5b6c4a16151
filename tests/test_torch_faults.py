"""The port's fault injection and bounded step retries, held against the
JAX engine.

* ``runtime/faults.py`` (the port's copy) fires on exactly JAX's schedule
  for every seed and site, and poisons the same request ids;
* a chaos run (injected allocation, copy-on-write and step failures, a
  poisoned request, a cancel mid-flight) ends with the JAX engine's
  terminal statuses, reasons, streams and fault statistics on the same
  weights (``convert.params_from_jax``) and traffic, with the prefix
  cache and speculation off and on; every request that ends OK emits the
  fault-free run's stream, and the others a prefix of it;
* the overlapped loop under faults (its lookahead fast path off) ends
  with the synchronous loop's statuses, streams and scheduler trace;
* a step whose retries run out fails its request, not the engine.

Smoke width (d_model 48, 2 layers, vocab 128) on the CPU, where the steps
run eagerly through the kernels' plain versions.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.core import linear as jlin
from repro.models import model as JM
from repro.runtime import faults as jfl, serve_loop as jserve

from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.core import linear as tlin
from repro_torch.runtime import faults as tfl, scheduler as tsch
from repro_torch.runtime import serve_loop as tserve

ARCH = "h2o-danube-3-4b"
NARROW = dict(d_model=48, num_heads=4, num_kv_heads=2, head_dim=12,
              d_ff=96, num_layers=2)
ECFG = dict(max_batch=2, page_size=4, num_pages=24, max_seq_len=48,
            prefill_chunk=6)
PLAN = dict(seed=5, alloc_fail_rate=0.08, cow_fail_rate=0.2,
            step_error_rate=0.1, alloc_fail_at=(2,), poison_rids=(2,))
CANCEL = {8: 1}  # engine step -> rid cancelled after it


@pytest.fixture(scope="module")
def jax_tree():
    cfg = dataclasses.replace(jreg.smoke_config(ARCH), **NARROW)
    return jax.tree_util.tree_map(np.asarray,
                                  JM.init(cfg, jax.random.PRNGKey(0)))


def _engines(jax_tree, mode):
    sp = dict(pattern=(6, 8), mode=mode, recipe="int8", fused_attention=True)
    jcfg = dataclasses.replace(jreg.smoke_config(ARCH), **NARROW,
                               sparsity=jlin.SparsityConfig(
                                   use_pallas=False, **sp))
    tcfg = dataclasses.replace(treg.smoke_config(ARCH), **NARROW,
                               sparsity=tlin.SparsityConfig(**sp))
    jp = jserve.pack_params(jax_tree, jcfg)
    tp = tserve.pack_params(params_from_jax(jax_tree, tcfg, device="cpu"),
                            tcfg)
    return (lambda **kw: jserve.ServeEngine(jp, jcfg, jserve.EngineConfig(
                **ECFG, **kw)),
            lambda **kw: tserve.ServeEngine(tp, tcfg, tserve.EngineConfig(
                **ECFG, **kw), device="cpu"))


def _prompts(vocab=128):
    """A shared 8-token system prompt, each suffix a repeated phrase; the
    second request repeats the first (16 tokens, four full pages), so with
    the prefix cache it resumes inside a page the first still holds and
    must copy it."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, vocab, size=8).tolist()
    out = [shared + rng.integers(0, vocab, size=k).tolist() * 2
           for k in (4, 6, 5, 7)]
    return [out[0], list(out[0])] + out[1:]


def _drive(eng, cancel_at):
    for i, p in enumerate(_prompts()):
        eng.submit(p, 6, rid=i, arrival=i)

    def on_step(e, k):
        if k in cancel_at:
            e.cancel(cancel_at[k])
    out = eng.run(on_step=on_step)
    eng.kv.check()
    assert eng.kv.pool.num_free + eng.kv.pool.num_cached \
        == eng.ecfg.num_pages
    return {r: (c.status, c.reason, tuple(c.tokens)) for r, c in out.items()}


def _fault_stats(eng):
    s = eng.stats
    return (s.step_errors, s.step_retries, s.faults_injected, s.failed,
            s.cancelled, s.completed_ok, s.admission_deferrals,
            s.goodput_tokens, s.cow_copies, s.prefix_hit_tokens,
            eng.injector.describe())


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_injector_schedule_matches_jax(seed):
    plan = dict(PLAN, seed=seed, step_error_at=(3,), poison_rate=0.2)
    a = tfl.FaultInjector(tfl.FaultPlan(**plan))
    b = jfl.FaultInjector(jfl.FaultPlan(**plan))
    rng = np.random.default_rng(seed)
    for site in rng.choice(tfl.SITES, size=300):  # sites interleaved
        assert a.fire(site) == b.fire(site), site
    assert [a.poisoned(r) for r in range(60)] == \
        [b.poisoned(r) for r in range(60)]
    assert a.injected == b.injected and a.calls == b.calls
    assert a.describe() == b.describe()
    assert tfl.SITES == jfl.SITES
    assert 0 < a.total_injected < 300


@pytest.mark.parametrize("mode,kw", [
    ("compressed", {}),
    ("slided", {"prefix_cache": True}),
    ("compressed", {"prefix_cache": True, "speculate": 3})],
    ids=["plain", "prefix", "prefix-spec"])
def test_chaos_run_matches_jax_engine(jax_tree, mode, kw):
    jmake, tmake = _engines(jax_tree, mode)
    clean = _drive(tmake(**kw), {})
    assert all(st == tsch.OK for st, _, _ in clean.values())
    jeng = jmake(faults=jfl.FaultPlan(**PLAN), **kw)
    want = _drive(jeng, CANCEL)
    teng = tmake(faults=tfl.FaultPlan(**PLAN), **kw)
    teng.warmup()  # writes nothing and fires no fault
    got = _drive(teng, CANCEL)
    assert got == want
    assert teng.sched.trace == jeng.sched.trace
    assert _fault_stats(teng) == _fault_stats(jeng)
    assert got[2][:2] == (tsch.FAILED, tsch.REASON_POISONED)
    assert teng.stats.step_retries > 0
    if kw.get("prefix_cache"):  # the duplicate prompt copied a page
        assert teng.injector.calls["fork"] > 0
        assert teng.stats.cow_copies > 0
    for rid, (status, _, tokens) in got.items():
        if status == tsch.OK:  # survivors: the fault-free stream
            assert tokens == clean[rid][2], rid
        else:                  # the rest: a prefix of it
            assert tokens == clean[rid][2][:len(tokens)], rid


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_overlapped_loop_under_faults_matches_sync(jax_tree, prefix_cache):
    _, tmake = _engines(jax_tree, "compressed")
    runs = {}
    for async_loop in (False, True):
        eng = tmake(faults=tfl.FaultPlan(**PLAN), async_loop=async_loop,
                    prefix_cache=prefix_cache)
        runs[async_loop] = (_drive(eng, CANCEL), eng.sched.trace,
                            _fault_stats(eng), eng.stats.lookahead_steps)
    assert runs[True][:3] == runs[False][:3]
    assert runs[True][3] == 0, "the fast path must be off under faults"
    assert runs[False][0][2][0] == tsch.FAILED


def test_step_retries_exhausted_fail_the_request(jax_tree):
    jmake, tmake = _engines(jax_tree, "compressed")
    kw = dict(step_retries=1, retry_backoff_s=1e-3)
    outs = []
    for make, fl in ((jmake, jfl), (tmake, tfl)):
        eng = make(faults=fl.FaultPlan(seed=0, step_error_at=(0, 1)), **kw)
        rng = np.random.default_rng(0)
        for rid in range(2):
            eng.submit(rng.integers(0, 128, size=5).tolist(), 4, rid=rid)
        out = eng.run()
        eng.kv.check()
        assert eng.kv.pool.num_free == ECFG["num_pages"]
        outs.append(({r: (c.status, c.reason, tuple(c.tokens))
                      for r, c in out.items()}, eng.stats.step_errors))
    assert outs[1] == outs[0]
    got, step_errors = outs[1]
    assert got[0][:2] == (tsch.FAILED, tsch.REASON_STEP_ERROR)
    assert got[1][0] == tsch.OK and len(got[1][2]) == 4
    assert step_errors == 2
