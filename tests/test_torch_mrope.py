"""M-RoPE and the vision prefix (qwen2-vl) of the port held against the JAX
package at smoke width on the CPU (2 layers, d 64, 4 heads over 2 KV
heads of 16).

The same weights (JAX ``init``, carried across with ``params_from_jax``)
and inputs (numpy, seeded) go through both.  Tolerances:
- ``apply_mrope``: atol 2e-6 against JAX (the libraries' sin/cos round
  differently by an ulp; positions below 64, |x| ~ 1); with three equal
  streams it is bit-equal to the port's ``apply_rope``;
- logits: recipe ``none`` atol 1e-5; int8 within relative L2 3e-2 and
  max abs 0.1 of JAX's (ulp differences may flip an int8 rounding), the
  argmax equal;
- token streams: identical.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import linear as jlin
from repro.models import layers as JL, model as JM
from repro.runtime import serve_loop as jserve

from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.core import linear as tlin
from repro_torch.launch import serve as tlaunch
from repro_torch.models import layers as TL, model as TM
from repro_torch.runtime import serve_loop as tserve

ARCH = "qwen2-vl-72b"
B, S, N_VISION, NEW = 2, 14, 6, 8
ROPE_TOL, FLOAT_TOL, INT8_RL2, INT8_ABS = 2e-6, 1e-5, 3e-2, 0.1
ECFG = dict(max_batch=2, page_size=4, num_pages=24, max_seq_len=40,
            prefill_chunk=8)


@pytest.mark.parametrize("hd", [16, 128])
def test_apply_mrope_matches_jax(hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((B, 9, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 64, (3, B, 9)).astype(np.int32)
    got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    want = np.asarray(JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ROPE_TOL)
    # three equal streams: RoPE, bit for bit in the port, and JAX's M-RoPE
    same = np.repeat(pos[:1], 3, axis=0)
    got_eq = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(same), 1e4)
    assert torch.equal(got_eq, TL.apply_rope(torch.from_numpy(x),
                                             torch.from_numpy(pos[0]), 1e4))
    np.testing.assert_allclose(
        got_eq.numpy(),
        np.asarray(JL.apply_mrope(jnp.asarray(x), jnp.asarray(same), 1e4)),
        rtol=0, atol=ROPE_TOL)
    assert not torch.equal(got_eq, got)


@functools.cache
def _tree():
    cfg = jreg.smoke_config(ARCH)
    assert cfg.m_rope and cfg.frontend == "vision"
    return jax.tree_util.tree_map(np.asarray,
                                  JM.init(cfg, jax.random.PRNGKey(0)))


@functools.cache
def _packed(mode, recipe):
    sp = dict(fused_attention=True)
    if mode != "dense":
        sp.update(pattern=(6, 8), mode=mode, recipe=recipe)
    jcfg = dataclasses.replace(jreg.smoke_config(ARCH), sparsity=jlin.
                               SparsityConfig(use_pallas=False, **sp))
    tcfg = dataclasses.replace(treg.smoke_config(ARCH),
                               sparsity=tlin.SparsityConfig(**sp))
    tree = _tree()
    return (jcfg, jserve.pack_params(tree, jcfg), tcfg,
            tserve.pack_params(params_from_jax(tree, tcfg, device="cpu"),
                               tcfg))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 128, (B, S)).astype(np.int32)
    vision = rng.standard_normal((B, N_VISION, 64)).astype(np.float32)
    return toks, vision


CASES = [("dense", "none"), ("compressed", "int8"), ("slided", "int8")]


@pytest.mark.parametrize("mode,recipe", CASES,
                         ids=[f"{m}-{r}" for m, r in CASES])
def test_prefill_with_vision_prefix_matches_jax(mode, recipe):
    jcfg, jp, tcfg, tp = _packed(mode, recipe)
    toks, vision = _inputs(0)
    want = np.asarray(JM.prefill(jp, jcfg, {
        "tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(vision)})[0])
    got = TM.prefill(tp, tcfg, torch.from_numpy(toks),
                     extra_embeds=torch.from_numpy(vision))[0].numpy()
    if recipe == "none":
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)
    else:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= INT8_RL2
        assert np.abs(got - want).max() <= INT8_ABS
    assert (got.argmax(-1) == want.argmax(-1)).all()
    # the prefix reaches the logits
    text = TM.prefill(tp, tcfg, torch.from_numpy(toks))[0].numpy()
    assert np.abs(text - got).max() > 10 * INT8_ABS


@pytest.mark.parametrize("mode", ["compressed", "slided"])
def test_generate_with_vision_prefix_matches_jax(mode):
    jcfg, jp, tcfg, tp = _packed(mode, "int8")
    toks, vision = _inputs(1)
    want, _ = jserve.generate(jp, jcfg, {
        "tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(vision)},
        NEW)
    got, _ = tserve.generate(tp, tcfg, torch.from_numpy(toks), NEW,
                             extra_embeds=torch.from_numpy(vision))
    assert got.tolist() == np.asarray(want).tolist()


def _serve(eng, prompts):
    for i, p in enumerate(prompts):
        eng.submit(p, NEW, rid=i, arrival=2 * i)  # staggered joins
    out = eng.run()
    eng.kv.check()
    return {rid: c.tokens for rid, c in out.items()}


@pytest.mark.parametrize("mode", ["compressed", "slided"])
def test_engine_streams_match_jax_engine(mode):
    """Text-only traffic through both paged engines (2-D positions: the
    three M-RoPE streams equal), fused attention, int8."""
    jcfg, jp, tcfg, tp = _packed(mode, "int8")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, size=n).tolist() for n in (5, 11, 7)]
    want = _serve(jserve.ServeEngine(jp, jcfg, jserve.EngineConfig(**ECFG)),
                  prompts)
    got = _serve(tserve.ServeEngine(tp, tcfg, tserve.EngineConfig(**ECFG),
                                    device="cpu"), prompts)
    assert all(len(t) == NEW for t in got.values())
    assert got == want


def test_launcher_serves_qwen2_vl_engine(capsys):
    tlaunch.main(["--arch", ARCH, "--smoke", "--sparse", "6", "8",
                  "--precision", "int8", "--engine", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"])
    assert "2 requests" in capsys.readouterr().out
