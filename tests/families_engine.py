"""Shared by the ``test_torch_families_engine*.py`` files: the port's
``ServeEngine`` and the JAX ``ServeEngine`` serving the same smoke-width
weights and staggered traffic (the files split the cases so that the
test workers share their load)."""
import dataclasses
import functools

import jax
import numpy as np

from repro.configs import registry as jreg
from repro.core import linear as jlin
from repro.models import model as JM
from repro.runtime import serve_loop as jserve

from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.core import linear as tlin
from repro_torch.runtime import serve_loop as tserve

ECFG = dict(max_batch=2, page_size=4, num_pages=24, max_seq_len=40,
            prefill_chunk=8)
NEW_TOKENS = 6


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


@functools.cache
def _tree(arch):
    cfg = jreg.smoke_config(arch)
    return _random_wo(jax.tree_util.tree_map(
        np.asarray, JM.init(cfg, jax.random.PRNGKey(0))), cfg)


def _cfgs(arch, mode, recipe, **over):
    sp = dict(pattern=(6, 8), mode=mode, recipe=recipe, fused_attention=True)
    jcfg = dataclasses.replace(jreg.smoke_config(arch), **over,
                               sparsity=jlin.SparsityConfig(
                                   use_pallas=False, **sp))
    tcfg = dataclasses.replace(treg.smoke_config(arch), **over,
                               sparsity=tlin.SparsityConfig(**sp))
    return jcfg, tcfg


def _traffic():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 128, size=int(n)).tolist() for n in (5, 11, 7)]


def _serve(eng, prompts):
    for i, p in enumerate(prompts):
        eng.submit(p, NEW_TOKENS, rid=i, arrival=2 * i)  # staggered joins
    out = eng.run()
    eng.kv.check()
    return {rid: c.tokens for rid, c in out.items()}


def case_id(arch, mode, recipe, cf):
    return f"{arch.split('-')[0]}-{mode}-{recipe}-cf{cf:g}"


def check_case(arch, mode, recipe, cf):
    """The port engine's greedy streams equal the JAX engine's."""
    prompts = _traffic()
    jcfg, tcfg = _cfgs(arch, mode, recipe, moe_capacity_factor=cf)
    tree = _tree(arch)
    want = _serve(jserve.ServeEngine(jserve.pack_params(tree, jcfg), jcfg,
                                     jserve.EngineConfig(**ECFG)), prompts)
    teng = tserve.ServeEngine(
        tserve.pack_params(params_from_jax(tree, tcfg, device="cpu"), tcfg),
        tcfg, tserve.EngineConfig(**ECFG), device="cpu")
    teng.warmup()  # writes nothing: the streams below are unaffected
    got = _serve(teng, prompts)
    assert all(len(t) == NEW_TOKENS for t in got.values())
    assert got == want
