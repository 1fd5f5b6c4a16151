"""The other model families served by the port's engine, held against the
JAX engine: granite-moe (attention + MoE), mamba2 (SSD only), mixtral
(sliding-window attention + MoE) and the jamba hybrid (SSD + attention
layers, MoE on every other layer), at smoke width on the CPU.

The port's ``ServeEngine`` and the JAX ``ServeEngine`` serve the same
weights (JAX ``init``, every SSM ``wo`` drawn in numpy, since JAX
zero-initialises it) and the same staggered traffic, and must emit
IDENTICAL greedy streams, compressed and slided, recipes ``none`` and
``int8``; one granite case at the registered capacity factor 1.25, where
the decode batch's tokens compete for expert capacity; and the dense
gemma3, phi3 and minitron configs, compressed int8.  The one-shot
``generate`` parity is in ``test_torch_moe.py`` and ``test_torch_ssm.py``.
"""
import dataclasses
import functools

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

ARCHS = ["granite-moe-3b-a800m", "mamba2-780m", "mixtral-8x22b",
         "jamba-1.5-large-398b"]
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


CASES = [(a, m, r, 16.0) for a in ARCHS for m in ("compressed", "slided")
         for r in ("none", "int8")]
CASES += [("granite-moe-3b-a800m", m, "int8", 1.25)
          for m in ("compressed", "slided")]
# the dense configs of the rest of ROADMAP A.3 (gemma3's 5:1 local:global
# windows, plain GQA): they need no code of their own
CASES += [(a, "compressed", "int8", 16.0)
          for a in ("gemma3-12b", "phi3-medium-14b", "minitron-4b")]


@pytest.mark.parametrize("arch,mode,recipe,cf", CASES,
                         ids=[f"{a.split('-')[0]}-{m}-{r}-cf{c:g}"
                              for a, m, r, c in CASES])
def test_family_engine_streams_match_jax_engine(arch, mode, recipe, cf):
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
