"""The encoder-decoder (whisper) of the port held against ``repro.models.
encdec`` at smoke width on the CPU (2 encoder + 2 decoder layers, d 64,
8 audio frames).

The same weights (JAX ``init``, carried across with ``params_from_jax``)
and the same inputs (numpy, seeded) go through both.  Tolerances:
- the sinusoidal tables differ only by the libraries' sin/cos, which
  reduce an fp32 angle differently: atol two ulps of the largest angle
  (2.4e-4 at whisper's 1500 frames, 3.1e-5 measured; 9.5e-7 at 8);
- recipe ``none``: atol 1e-5 on every output (fp32 reassociation, ~1e-6
  measured);
- int8 recipes: those ulp differences (sin/cos, rsqrt in RMSNorm, tanh in
  GELU) flip some per-token int8 roundings, so each output is held
  within relative L2 3e-2 of JAX's (~1e-2 measured) and max abs 0.1;
  the packed weights are bit-equal and ``generate``'s streams identical.
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
from repro.models import encdec as JE, layers as JL, model as JM
from repro.runtime import serve_loop as jserve

from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.core import linear as tlin
from repro_torch.kernels import fused_slide_matmul as tfsm
from repro_torch.launch import serve as tlaunch
from repro_torch.models import encdec as TE, layers as TL, model as TM
from repro_torch.runtime import serve_loop as tserve

ARCH = "whisper-small"
B, S, NEW = 2, 12, 8
FLOAT_TOL, INT8_RL2, INT8_ABS = 1e-5, 3e-2, 0.1


@functools.cache
def _tree():
    cfg = jreg.smoke_config(ARCH)
    return jax.tree_util.tree_map(np.asarray,
                                  JM.init(cfg, jax.random.PRNGKey(0)))


@functools.cache
def _packed(mode, recipe, fuse):
    sp = dict(fuse_epilogue=fuse)
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


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    audio = rng.standard_normal(
        (B, cfg.max_source_positions, cfg.d_model)).astype(np.float32)
    return toks, audio


def _close(got, want, quantized):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    if not quantized:
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)
        return
    rl2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rl2 <= INT8_RL2, rl2
    assert np.abs(got - want).max() <= INT8_ABS


def _angle_tol(max_pos):
    """Two ulps of the largest angle (position x frequency 1)."""
    return 2 * float(np.spacing(np.float32(max(max_pos, 1))))


@pytest.mark.parametrize("n,d", [(8, 64), (100, 64), (1500, 768)])
def test_sinusoidal_positions_match_jax(n, d):
    want = np.asarray(JL.sinusoidal_positions(n, d))
    got = TL.sinusoidal_positions(n, d, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_angle_tol(n - 1))
    pos = np.array([0, 3, 17, n - 1, n // 2], dtype=np.int32)
    np.testing.assert_allclose(
        TL.sinusoidal_positions_at(torch.from_numpy(pos), d).numpy(),
        np.asarray(JL.sinusoidal_positions_at(jnp.asarray(pos), d)),
        rtol=0, atol=_angle_tol(n - 1))


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


@pytest.mark.parametrize("mode", ["compressed", "slided"])
def test_pack_params_match_jax_per_layer(mode):
    """The encoder and decoder stacks carry across layer by layer and pack
    to JAX's packed leaves, bit for bit (int8; slided: the port's 2:4
    operand of Phi(W) inverted to JAX's ``w_slided``)."""
    jcfg, jp, tcfg, tp = _packed(mode, "int8", False)
    assert len(tp["encoder"]) == tcfg.encoder_layers == 2
    assert len(tp["decoder"]) == tcfg.num_layers == 2
    pairs = [(jp["lm_head"], tp["lm_head"]), (jp["embed"], tp["embed"])]
    for stack, blocks in (("encoder", ("attn", "mlp")),
                          ("decoder", ("self_attn", "cross_attn", "mlp"))):
        for i, tl in enumerate(tp[stack]):
            jl = jax.tree_util.tree_map(lambda a: np.asarray(a)[i],
                                        jp[stack])
            for blk in blocks:
                pairs += [(jl[blk][k], tl[blk][k]) for k in jl[blk]]
            pairs += [(jl[k], tl[k]) for k in jl if k.endswith("norm")]
    n_linear = 0
    for jn, tn in pairs:
        if "sp_values" in tn:  # the 2:4 operand, inverted: JAX's Phi(W)
            m, gk = np.shape(jn["w_slided"])
            tn = {"s_w": tn["s_w"], "w_slided": tfsm.dense_from_operand(
                tn["sp_values"], tn["sp_meta"], m, gk)}
        assert set(jn) == set(tn)
        n_linear += "s_w" in jn
        for key in jn:
            assert np.shape(jn[key]) == tuple(tn[key].shape), key
            np.testing.assert_array_equal(_bits(jn[key]), _bits(tn[key]))
    assert n_linear == 2 * 6 + 2 * 10 + 1


FORWARD = [("dense", "none", False), ("compressed", "none", False),
           ("compressed", "int8", False), ("compressed", "int8", True),
           ("slided", "int8", False), ("slided", "int8", True)]


@pytest.mark.parametrize("mode,recipe,fuse", FORWARD,
                         ids=[f"{m}-{r}-{'fused' if f else 'unfused'}"
                              for m, r, f in FORWARD])
def test_forward_matches_jax(mode, recipe, fuse):
    """encode, prefill (logits, self caches, enc_out) and one serve_step."""
    jcfg, jp, tcfg, tp = _packed(mode, recipe, fuse)
    q = recipe != "none"
    toks, audio = _inputs(tcfg)
    _close(TE.encode(tp, tcfg, torch.from_numpy(audio)),
           JE.encode(jp, jcfg, jnp.asarray(audio)), q)
    max_len = S + 4
    jl, jc, jk = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                       "audio_embeds": jnp.asarray(audio)},
                            max_len=max_len)
    tl, tc, tk = TM.prefill(tp, tcfg, torch.from_numpy(toks), max_len=max_len,
                            extra_embeds=torch.from_numpy(audio))
    _close(tl, jl, q)
    _close(tc["enc_out"], jc["enc_out"], q)
    assert tk.tolist() == np.asarray(jk).tolist() == [S] * B
    for i, layer in enumerate(tc["self"]):
        for key in ("k", "v"):
            _close(layer[key], np.asarray(jc["self"][key])[i], q)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jd, _, jk2 = JM.serve_step(jp, jcfg, jnp.asarray(nxt), jc, jk)
    td, tc2, tk2 = TM.serve_step(tp, tcfg, torch.from_numpy(nxt), tc, tk)
    _close(td, jd, q)
    assert tk2.tolist() == np.asarray(jk2).tolist() == [S + 1] * B
    assert tc2["enc_out"] is tc["enc_out"]


GENERATE = [("compressed", "none"), ("slided", "none"),
            ("compressed", "int8"), ("slided", "int8")]


@pytest.mark.parametrize("mode,recipe", GENERATE,
                         ids=[f"{m}-{r}" for m, r in GENERATE])
def test_generate_matches_jax_generate(mode, recipe):
    jcfg, jp, tcfg, tp = _packed(mode, recipe, False)
    toks, audio = _inputs(tcfg, seed=1)
    want, _ = jserve.generate(jp, jcfg, {"tokens": jnp.asarray(toks),
                                         "audio_embeds": jnp.asarray(audio)},
                              NEW)
    got, stats = tserve.generate(tp, tcfg, torch.from_numpy(toks), NEW,
                                 extra_embeds=torch.from_numpy(audio))
    assert got.tolist() == np.asarray(want).tolist()
    assert stats.tokens_generated == B * NEW


def _shapes(node):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in node.items()}


@pytest.mark.parametrize("arch", [ARCH, "jamba-1.5-large-398b"])
def test_make_cache_matches_jax_layout(arch):
    """M.make_cache: JAX's dense one-shot cache, its [L, ...] stacks split
    per layer (per unit for a decoder, whose units mix SSM state and
    attention caches in jamba)."""
    cfg = jreg.smoke_config(arch)
    want = JM.make_cache(cfg, B, 20)
    got = TM.make_cache(treg.smoke_config(arch), B, 20, device="cpu")
    if cfg.is_encoder_decoder:
        assert tuple(got["enc_out"].shape) == want["enc_out"].shape
        got, want = got["self"], want["self"]
    assert len(got) == jax.tree_util.tree_leaves(want)[0].shape[0]
    one = jax.tree_util.tree_map(lambda a: a[0], want)
    for layer in got:
        assert _shapes(layer) == _shapes(one)


def test_engine_and_paged_cache_refuse_whisper():
    """As in JAX: the paged engine is decoder-only, and make_paged_cache
    refuses with JAX's message."""
    jcfg, tcfg = jreg.smoke_config(ARCH), treg.smoke_config(ARCH)
    with pytest.raises(NotImplementedError) as jerr:
        JM.make_paged_cache(jcfg, 8, 4, 2)
    with pytest.raises(NotImplementedError) as terr:
        TM.make_paged_cache(tcfg, 8, 4, 2, device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        jserve.ServeEngine({}, jcfg)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        tserve.ServeEngine({}, tcfg, device="cpu")
    with pytest.raises(ValueError, match="audio frames"):
        TM.prefill({}, tcfg, torch.zeros((1, 2), dtype=torch.int32))


def test_launcher_serves_whisper_one_shot(capsys):
    tlaunch.main(["--arch", ARCH, "--smoke", "--sparse", "6", "8",
                  "--precision", "int8", "--device", "cpu", "--batch", "2",
                  "--prompt-len", "8", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "[launch.serve] prefill" in out and "sample:" in out
    with pytest.raises(NotImplementedError, match="decoder-only"):
        tlaunch.main(["--arch", ARCH, "--smoke", "--engine", "--device",
                      "cpu"])
