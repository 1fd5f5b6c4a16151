"""The port's MoE FFN (``repro_torch.models.moe``) held against
``repro.models.moe``.

* ``moe.apply`` equals JAX's at capacity factor 16.0 (no drops, the
  smoke configs' setting) and at the registered 1.25, shaped as a prefill
  chunk and as a decode step, in dense and compressed modes; the 1.25
  cases must drop slots.  fp32 on the CPU; tolerance 2e-6 absolute on
  outputs of O(1) (the routing, capacity positions and slot map are
  integer-exact; only the float sums reassociate).
* Routing ties break by the lower expert index, as ``jax.lax.top_k``.
* ``serve_loop.pack_params`` prunes the expert stacks once at load, bit
  for bit JAX's ``prune_to_pattern``, and leaves the router alone; the
  pruned block computes what the unpruned block computes on every call.
* One-shot ``generate`` on granite-moe at smoke width emits JAX's
  ``generate`` tokens, recipes ``none`` and ``int8`` (ROADMAP A.3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import linear as jlin, packer as jpacker
from repro.core.patterns import Pattern
from repro.models import model as JM, moe as jmoe
from repro.runtime import serve_loop as jserve

from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import linear as tlin
from repro_torch.models import moe as tmoe
from repro_torch.runtime import serve_loop as tserve

SPEC = dict(d_model=64, d_ff=96, num_experts=8, top_k=2)
SHAPES = {"prefill": (1, 48), "decode": (4, 1)}
TOL = 2e-6


def _drops(p, spec, x):
    """Slots past capacity under JAX's routing (lax.top_k, (t, k)-major
    queue positions), counted in numpy."""
    t = x.shape[0] * x.shape[1]
    tg = min(spec.group_size, t)
    cap = max(1, int(spec.capacity_factor * tg * spec.top_k
                     / spec.num_experts))
    logits = x.reshape(t // tg, tg, -1) @ p["router"]["w"].T
    idx = np.asarray(jax.lax.top_k(jnp.asarray(logits), spec.top_k)[1])
    drops = 0
    for grp in idx:
        seen = np.zeros(spec.num_experts, np.int64)
        for e in grp.reshape(-1):
            drops += seen[e] >= cap
            seen[e] += 1
    return int(drops)


@pytest.mark.parametrize("mode", ["dense", "compressed"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("cf", [16.0, 1.25])
def test_moe_apply_matches_jax(cf, shape, mode):
    spec = jmoe.MoESpec(capacity_factor=cf, **SPEC)
    p = jax.tree_util.tree_map(np.asarray,
                               jmoe.init(jax.random.PRNGKey(3), spec))
    x = np.random.default_rng(7).standard_normal(
        SHAPES[shape] + (spec.d_model,)).astype(np.float32)
    pattern = None if mode == "dense" else (6, 8)
    want = np.asarray(jmoe.apply(
        p, spec, jnp.asarray(x), jlin.SparsityConfig(
            pattern=pattern, mode=mode, use_pallas=False)))
    tsp = tlin.SparsityConfig(pattern=pattern, mode=mode)
    tp = jax.tree_util.tree_map(lambda a: to_torch(a, "cpu"), p)
    got = tmoe.apply(tp, tmoe.MoESpec(**dataclasses.asdict(spec)),
                     torch.from_numpy(x), tsp)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    drops = _drops(p, spec, x)
    if cf < 16:
        assert drops > 0, "capacity factor 1.25 must drop slots here"
    else:
        assert drops == 0


def test_top_k_breaks_ties_like_jax():
    rng = np.random.default_rng(0)
    # few distinct values: most rows hold ties across the top k
    logits = rng.integers(0, 3, size=(5, 7, 8)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(logits), 3)
    tv, ti = tmoe._top_k(torch.from_numpy(logits), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("mode", ["compressed", "slided"])
def test_pack_params_prunes_expert_stacks_like_jax(mode):
    arch = "granite-moe-3b-a800m"
    jcfg = jreg.smoke_config(arch)
    tree = jax.tree_util.tree_map(np.asarray,
                                  JM.init(jcfg, jax.random.PRNGKey(0)))
    tcfg = dataclasses.replace(treg.smoke_config(arch),
                               sparsity=tlin.SparsityConfig(
                                   pattern=(6, 8), mode=mode, recipe="int8"))
    raw = params_from_jax(tree, tcfg, device="cpu")
    packed = tserve.pack_params(raw, tcfg)
    for u, unit in enumerate(packed["units"]):
        ffn = unit["layer_0"]["ffn"]
        assert ffn["router"] is raw["units"][u]["layer_0"]["ffn"]["router"]
        for name in ("w_gate", "w_up", "w_down"):
            assert set(ffn[name]) == {"pruned"}
            want = jpacker.prune_to_pattern(
                jnp.asarray(tree["units"]["layer_0"]["ffn"][name]["w"][u]),
                Pattern(6, 8))
            np.testing.assert_array_equal(ffn[name]["pruned"].numpy(),
                                          np.asarray(want))
        # the attention linears are prepared as before
        assert "w" not in unit["layer_0"]["mixer"]["wq"]
    # pruning once at load computes what pruning on every call computes
    spec = tmoe.MoESpec(d_model=tcfg.d_model, d_ff=tcfg.d_ff,
                        num_experts=tcfg.moe_num_experts,
                        top_k=tcfg.moe_top_k)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 5, tcfg.d_model)).astype(np.float32))
    lazy = tmoe.apply(raw["units"][0]["layer_0"]["ffn"], spec, x,
                      tcfg.sparsity)
    once = tmoe.apply(packed["units"][0]["layer_0"]["ffn"], spec, x,
                      tcfg.sparsity)
    assert torch.equal(lazy, once)


@pytest.mark.parametrize("recipe", ["none", "int8"])
def test_generate_matches_jax_generate(recipe):
    arch = "granite-moe-3b-a800m"
    sp = dict(pattern=(6, 8), mode="compressed", recipe=recipe)
    jcfg = dataclasses.replace(jreg.smoke_config(arch),
                               sparsity=jlin.SparsityConfig(use_pallas=False,
                                                            **sp))
    tcfg = dataclasses.replace(treg.smoke_config(arch),
                               sparsity=tlin.SparsityConfig(**sp))
    tree = jax.tree_util.tree_map(np.asarray,
                                  JM.init(jcfg, jax.random.PRNGKey(0)))
    prompts = np.random.default_rng(5).integers(
        0, 128, size=(2, 12)).astype(np.int32)
    want, _ = jserve.generate(jserve.pack_params(tree, jcfg), jcfg,
                              {"tokens": prompts}, 6)
    got, _ = tserve.generate(
        tserve.pack_params(params_from_jax(tree, tcfg, device="cpu"), tcfg),
        tcfg, torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
