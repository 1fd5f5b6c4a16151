"""The port's Mamba-2 SSD block (``repro_torch.models.ssm``) and its
threading through the paged engine, held against ``repro.models.ssm``.

* ``ssm.apply`` equals JAX's in its three modes: prefill from zero state
  (S not a multiple of the chunk: the scan pads), chunked continuation
  from a nonzero SSD/conv state with right-padding (``valid_len`` [13, 7])
  and O(1) decode.  fp32 on the CPU; tolerance 1e-5 absolute on outputs
  of O(1) and 1e-7 on SSD states of O(1e-2) (the chunk einsums
  reassociate); the carried conv window, projections of the inputs,
  within 1e-5.
* ``init`` keeps JAX's deterministic leaves, ``wo`` zero among them: a
  random-weight block is the identity, so every engine test here draws
  ``wo`` itself.
* A decode step keeps an inactive slot's SSM state bit for bit (the
  port's ``test_paged_engine_decode_preserves_midprefill_ssm_state``),
  and an engine schedule that interleaves a decode step between two
  prefill chunks of one request emits the JAX engine's streams.
* The engine refuses the prefix cache and speculation on SSM stacks, as
  JAX's does, and builds a copy-on-write step only over a page pool.
* One-shot ``generate`` on mamba2 at smoke width emits JAX's ``generate``
  tokens, recipes ``none`` and ``int8`` (ROADMAP A.3).
* JAX's ``test_paged_engine_hybrid_ssm_arch`` cell (red on the
  reference): the port's one-shot and engine reproduce JAX's one-shot and
  engine streams, and with fp32 KV pages the port's engine equals its
  one-shot, so the red test's disagreement is the bf16 rounding of the
  prefill chunk's K/V pages, not an engine fault.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import linear as jlin
from repro.models import model as JM, ssm as jssm
from repro.runtime import serve_loop as jserve

from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import linear as tlin
from repro_torch.models import model as TM, ssm as tssm, transformer as TT
from repro_torch.runtime import serve_loop as tserve

SPEC = dict(d_model=64, d_state=16, head_dim=16, chunk=8)
TOL, STATE_TOL = 1e-5, 1e-7
ARCH = "mamba2-780m"


def _random_wo(tree, cfg, seed=11):
    """Overwrite every SSM layer's zero ``wo`` with N(0, 1) * d_inner^-0.5
    (numpy, in the tree's dtype), so the block reaches the residual."""
    rng = np.random.default_rng(seed)
    for i, kind in enumerate(cfg.unit_pattern):
        if kind == "ssm":
            leaf = tree["units"][f"layer_{i}"]["mixer"]["wo"]
            w = leaf["w"]
            leaf["w"] = (rng.standard_normal(w.shape)
                         * w.shape[-1] ** -0.5).astype(w.dtype)
    return tree


def _block():
    spec = jssm.SSMSpec(**SPEC)
    p = jax.tree_util.tree_map(np.asarray,
                               jssm.init(jax.random.PRNGKey(1), spec))
    w = p["wo"]["w"]
    p["wo"]["w"] = (np.random.default_rng(5).standard_normal(w.shape)
                    * spec.d_inner ** -0.5).astype(np.float32)
    return spec, p, tssm.SSMSpec(**SPEC), jax.tree_util.tree_map(
        lambda a: to_torch(a, "cpu"), p)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("mode", ["prefill", "chunked", "decode"])
def test_ssm_apply_matches_jax(mode):
    spec, p, tspec, tp = _block()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 13, spec.d_model)).astype(np.float32)
    jsp, tsp = jlin.SparsityConfig(), tlin.SparsityConfig()
    # a nonzero carried state: the prefill of another 13 tokens
    x0 = rng.standard_normal((2, 13, spec.d_model)).astype(np.float32)
    _, jc = jssm.apply(p, spec, jnp.asarray(x0), jsp)
    _, tc = tssm.apply(tp, tspec, torch.from_numpy(x0), tsp)
    if mode == "prefill":
        want = jssm.apply(p, spec, jnp.asarray(x), jsp)
        got = tssm.apply(tp, tspec, torch.from_numpy(x), tsp)
    elif mode == "chunked":
        vl = np.asarray([13, 7], np.int32)
        want = jssm.apply(p, spec, jnp.asarray(x), jsp, cache=jc,
                          chunked=True, valid_len=jnp.asarray(vl))
        got = tssm.apply(tp, tspec, torch.from_numpy(x), tsp, cache=tc,
                         chunked=True, valid_len=torch.from_numpy(vl))
    else:
        want = jssm.apply(p, spec, jnp.asarray(x[:, :1]), jsp, cache=jc)
        got = tssm.apply(tp, tspec, torch.from_numpy(x[:, :1]), tsp,
                         cache=tc)
    assert float(np.abs(np.asarray(want[1]["ssd"])).max()) > 1e-3
    _close(got[0].numpy(), want[0], TOL)
    _close(got[1]["ssd"].numpy(), want[1]["ssd"], STATE_TOL)
    _close(got[1]["conv"].numpy(), want[1]["conv"], TOL)


def test_ssm_init_keeps_jax_leaves():
    spec, p, tspec, _ = _block()
    got = tssm.init(torch.Generator().manual_seed(0), tspec)
    want = jssm.init(jax.random.PRNGKey(1), spec)
    assert not got["wo"]["w"].any()
    for name in ("A_log", "dt_bias", "D"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got["norm"]["g"].numpy(),
                                  np.asarray(want["norm"]["g"]))
    for name in ("conv_w", "wx", "wz", "wB", "wC", "wdt"):
        leaf_t, leaf_j = got[name], want[name]
        if isinstance(leaf_t, dict):
            leaf_t, leaf_j = leaf_t["w"], leaf_j["w"]
        assert leaf_t.shape == leaf_j.shape


def test_draw_ssm_wo_draws_only_ssm_blocks():
    # the launchers' random-weight models: every SSM block's wo drawn
    # N(0, 1) * d_inner^-0.5 (std within 10% at smoke width), every other
    # leaf as init made it
    cfg = treg.smoke_config("jamba-1.5-large-398b")
    params = TM.init(cfg, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in _leaves(params)}
    TM.draw_ssm_wo(params, cfg, torch.Generator().manual_seed(1))
    scale = TT.ssm_spec(cfg).d_inner ** -0.5
    drawn = 0
    for key, leaf in _leaves(params):
        if key.endswith("mixer/wo/w") and "A_log" in _node(params, key):
            drawn += 1
            assert not before[key].any()
            assert abs(leaf.std().item() / scale - 1) < 0.1, key
        else:
            assert torch.equal(leaf, before[key]), key
    assert drawn == cfg.num_units * cfg.unit_pattern.count("ssm") > 0


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], node


def _node(params, key):
    """The mixer dict that holds the leaf ``key`` (.../mixer/wo/w)."""
    node = params
    for part in key.split("/")[:-2]:
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


@pytest.fixture(scope="module")
def mamba_tree():
    cfg = jreg.smoke_config(ARCH)
    tree = jax.tree_util.tree_map(np.asarray,
                                  JM.init(cfg, jax.random.PRNGKey(0)))
    return _random_wo(tree, cfg)


def test_paged_engine_decode_preserves_midprefill_ssm_state(mamba_tree):
    cfg = treg.smoke_config(ARCH)
    params = params_from_jax(mamba_tree, cfg, device="cpu")
    cache = TM.make_paged_cache(cfg, num_pages=16, page_size=4, max_batch=2,
                                device="cpu")
    for unit in cache:  # recognizable state in slot 1 (the inactive one)
        for state in unit.values():
            for a in state.values():
                a[1] = 1.0
    old = [{k: a.clone() for k, a in st.items()}
           for unit in cache for st in unit.values()]
    pt = torch.zeros((2, 6), dtype=torch.int32)
    pt[0, 0] = 1
    TM.paged_decode_step(params, cfg, torch.tensor([3, 0]), cache, pt,
                         torch.tensor([4, 0], dtype=torch.int32),
                         torch.tensor([True, False]), 4)
    new = [st for unit in cache for st in unit.values()]
    changed = False
    for o, n in zip(old, new):
        for k in o:
            assert torch.equal(n[k][1], o[k][1]), \
                "inactive slot's SSM state was clobbered by decode"
            changed |= not torch.equal(n[k][0], o[k][0])
    assert changed, "active slot's state should have advanced"

    # a schedule that interleaves a decode step between two prefill
    # chunks of request 1 emits the JAX engine's streams
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=5).tolist(),
               rng.integers(0, cfg.vocab_size, size=11).tolist()]
    ecfg = dict(max_batch=2, page_size=4, num_pages=16, max_seq_len=24,
                prefill_chunk=6)
    streams = []
    for eng in (jserve.ServeEngine(mamba_tree, jreg.smoke_config(ARCH),
                                   jserve.EngineConfig(**ecfg)),
                tserve.ServeEngine(params, cfg, tserve.EngineConfig(**ecfg),
                                   device="cpu")):
        for i, p in enumerate(prompts):
            eng.submit(p, 4, rid=i, arrival=i)
        streams.append({r: c.tokens for r, c in eng.run().items()})
        eng.kv.check()
    trace = eng.sched.trace
    chunks = [i for i, t in enumerate(trace) if t.startswith("prefill r1")]
    assert len(chunks) >= 2, trace
    assert any(trace[i].startswith("decode")
               for i in range(chunks[0] + 1, chunks[-1])), trace
    assert streams[1] == streams[0]


@pytest.mark.parametrize("arch", [ARCH, "jamba-1.5-large-398b"])
@pytest.mark.parametrize("feature", ["prefix_cache", "speculate"])
def test_engine_refuses_features_on_ssm_stacks(arch, feature):
    cfg = treg.smoke_config(arch)
    params = TM.init(cfg, torch.Generator().manual_seed(0))
    kw = {"prefix_cache": True} if feature == "prefix_cache" \
        else {"speculate": 2}
    with pytest.raises(ValueError, match="attention-only stack"):
        tserve.ServeEngine(params, cfg, tserve.EngineConfig(**kw),
                           device="cpu")
    # the attention-only stacks take both
    dense = treg.smoke_config("granite-moe-3b-a800m")
    tserve.ServeEngine(TM.init(dense, torch.Generator().manual_seed(0)),
                       dense, tserve.EngineConfig(**kw), device="cpu")


@pytest.mark.parametrize("arch,cow", [(ARCH, False),
                                      ("jamba-1.5-large-398b", True),
                                      ("h2o-danube-3-4b", True)])
def test_engine_builds_a_cow_step_only_over_a_page_pool(arch, cow):
    """A stack with no attention layer has no page pool: its engine builds
    no copy-on-write step (the empty graph a capture would warn about),
    and warmup runs the steps that exist."""
    cfg = treg.smoke_config(arch)
    eng = tserve.ServeEngine(TM.init(cfg, torch.Generator().manual_seed(0)),
                             cfg, tserve.EngineConfig(), device="cpu")
    assert ("cow" in eng.captures) == cow
    assert set(eng.captures) == {"prefill", "decode"} | (
        {"cow"} if cow else set())
    eng.warmup()
    assert set(eng.captures.values()) == {0}  # the CPU runs eagerly


@pytest.mark.parametrize("recipe", ["none", "int8"])
def test_generate_matches_jax_generate(mamba_tree, recipe):
    sp = dict(pattern=(6, 8), mode="compressed", recipe=recipe)
    jcfg = dataclasses.replace(jreg.smoke_config(ARCH),
                               sparsity=jlin.SparsityConfig(use_pallas=False,
                                                            **sp))
    tcfg = dataclasses.replace(treg.smoke_config(ARCH),
                               sparsity=tlin.SparsityConfig(**sp))
    prompts = np.random.default_rng(5).integers(
        0, 128, size=(2, 12)).astype(np.int32)
    want, _ = jserve.generate(jserve.pack_params(mamba_tree, jcfg), jcfg,
                              {"tokens": prompts}, 6)
    got, _ = tserve.generate(
        tserve.pack_params(params_from_jax(mamba_tree, tcfg, device="cpu"),
                           tcfg), tcfg, torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_jamba_reference_cell_disagreement_is_bf16_kv():
    """JAX's red hybrid test: dense jamba at smoke width with JAX's own
    init (``wo`` zero), prompts of 11 and 6 tokens, 4 new tokens."""
    arch = "jamba-1.5-large-398b"
    cfg = jreg.smoke_config(arch)
    tree = jax.tree_util.tree_map(np.asarray,
                                  JM.init(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=k).tolist()
               for k in (11, 6)]
    ecfg = dict(max_batch=2, page_size=4, num_pages=24, max_seq_len=32,
                prefill_chunk=6)

    def serve(eng):
        for i, p in enumerate(prompts):
            eng.submit(p, 4, rid=i, arrival=i)
        return {r: c.tokens for r, c in eng.run().items()}

    def port(kv):
        tcfg = dataclasses.replace(treg.smoke_config(arch),
                                   kv_cache_dtype=kv)
        params = params_from_jax(tree, tcfg, device="cpu")
        one = {i: tserve.generate(params, tcfg,
                                  torch.tensor([p], dtype=torch.int32),
                                  4)[0][0].tolist()
               for i, p in enumerate(prompts)}
        return one, serve(tserve.ServeEngine(
            params, tcfg, tserve.EngineConfig(**ecfg), device="cpu"))

    j_one = {i: np.asarray(jserve.generate(
        tree, cfg, {"tokens": np.asarray([p], np.int32)}, 4)[0])[0].tolist()
        for i, p in enumerate(prompts)}
    j_eng = serve(jserve.ServeEngine(tree, cfg, jserve.EngineConfig(**ecfg)))
    t_one, t_eng = port("bfloat16")
    assert (t_one, t_eng) == (j_one, j_eng)
    assert t_one != t_eng  # the reference's red test, reproduced
    f_one, f_eng = port("float32")
    assert f_one == f_eng == t_eng
