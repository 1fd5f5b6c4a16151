"""Core algebra of the PyTorch port held BIT-EXACT against ``repro.core``.

Same inputs (made with numpy from a seed) go through the JAX function and
its port: magnitude pruning (ties broken by position), Phi, Psi, compress /
decompress, nibble packing, the quantizers and ``pack_params`` must agree
bit for bit, for the (2N-2):2N family N in {2, 3, 4} and every recipe.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import compressed as jcomp, linear as jlin, packer as jpk
from repro.core import precision as jprec, quant as jq, slide as jslide
from repro.core.patterns import Pattern, SlideDecomposition, TWO_FOUR
from repro.models import model as JM
from repro.runtime import serve_loop as jserve

from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import compressed as tcomp, linear as tlin
from repro_torch.core import packer as tpk, precision as tprec
from repro_torch.core import quant as tq, slide as tslide
from repro_torch.runtime import serve_loop as tserve

FAMILIES = [2, 3, 4]
RECIPES = sorted(jprec.RECIPES)


def bits(a) -> np.ndarray:
    """Raw bytes of a JAX/numpy array or torch tensor, for exact compare."""
    if isinstance(a, torch.Tensor):
        if a.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            a = a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int8)
        return a.cpu().numpy().view(np.uint8)
    a = np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


def assert_bit_equal(j, t):
    assert tuple(np.shape(j)) == tuple(t.shape)
    np.testing.assert_array_equal(bits(j), bits(t))


def _weights(rng, n, rows=12, groups=10):
    """Weights with many magnitude ties (values on a coarse grid, random
    signs) so the pairwise position tie-break is exercised."""
    k = 2 * n * groups
    w = rng.integers(-4, 5, size=(rows, k)).astype(np.float32) * 0.25
    return w


def _dec(n):
    return SlideDecomposition(Pattern.from_family(n), TWO_FOUR)


@pytest.mark.parametrize("n", FAMILIES)
def test_prune_phi_lift_match_jax(n):
    rng = np.random.default_rng(n)
    dec = _dec(n)
    w = _weights(rng, n)
    jw = jpk.prune_to_pattern(jnp.asarray(w), dec.source)
    tw = tpk.prune_to_pattern(torch.from_numpy(w), dec.source)
    assert_bit_equal(jw, tw)
    assert_bit_equal(jpk.magnitude_keep_mask(jnp.asarray(w), dec.source),
                     tpk.magnitude_keep_mask(torch.from_numpy(w), dec.source))
    assert_bit_equal(jslide.phi(jw, dec), tslide.phi(tw, dec))
    x = rng.standard_normal((3, w.shape[1])).astype(np.float32)
    assert_bit_equal(jslide.lift(jnp.asarray(x), dec),
                     tslide.lift(torch.from_numpy(x), dec))


@pytest.mark.parametrize("n", FAMILIES)
@pytest.mark.parametrize("packed", [False, True])
def test_compress_decompress_match_jax(n, packed):
    rng = np.random.default_rng(10 + n)
    dec = _dec(n)
    w = _weights(rng, n)
    if packed:  # int4-range values, as the 'w4' recipe stores them
        w = np.clip(np.round(w * 4), -7, 7).astype(np.int8)
    jws = jslide.phi(jpk.prune_to_pattern(jnp.asarray(w), dec.source), dec)
    tws = tslide.phi(tpk.prune_to_pattern(torch.from_numpy(w), dec.source),
                     dec)
    jc = jcomp.compress(jws, dec, pack_values=packed)
    tc = tcomp.compress(tws, dec, pack_values=packed)
    assert_bit_equal(jc.values, tc.values)
    assert_bit_equal(jc.indices, tc.indices)
    assert (jc.k, jc.packed) == (tc.k, tc.packed)
    # exact values; only the sign of an all-zero column may differ, since
    # XLA's dot emitter returns -0.0 or +0.0 there depending on the
    # contraction length (array_equal counts -0.0 == 0.0)
    np.testing.assert_array_equal(np.asarray(jcomp.decompress_original(jc)),
                                  tcomp.decompress_original(tc).numpy())


def test_nibbles_match_jax():
    v = np.arange(-8, 8, dtype=np.int8)
    v = np.stack(np.meshgrid(v, v), -1).reshape(-1)  # every (lo, hi) pair
    jp = jpk.pack_nibbles(jnp.asarray(v))
    tp = tpk.pack_nibbles(torch.from_numpy(v))
    assert_bit_equal(jp, tp)
    assert_bit_equal(jpk.unpack_nibbles(jp, 255), tpk.unpack_nibbles(tp, 255))
    np.testing.assert_array_equal(tpk.unpack_nibbles(tp).numpy(), v)


@pytest.mark.parametrize("which", ["int8", "fp8", "w_int8", "w_int4"])
def test_quantizers_match_jax(which):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((64, 48)).astype(np.float32)
    x *= np.exp(rng.uniform(-6, 6, size=(64, 1))).astype(np.float32)
    x[0] = 0.0           # all-zero row: absmax clamp
    x[1, :5] = [1.5, -1.5, 2.5, 0.5, -0.5]  # half-way rounding cases
    jfn = {"int8": jq.quantize_int8, "fp8": jq.quantize_fp8,
           "w_int8": jq.quantize_weight_int8_rowwise,
           "w_int4": jq.quantize_weight_int4_rowwise}[which]
    tfn = {"int8": tq.quantize_int8, "fp8": tq.quantize_fp8,
           "w_int8": tq.quantize_weight_int8_rowwise,
           "w_int4": tq.quantize_weight_int4_rowwise}[which]
    jr, tr = jfn(jnp.asarray(x)), tfn(torch.from_numpy(x))
    assert_bit_equal(jr.q, tr.q)
    assert_bit_equal(jr.scale, tr.scale)


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipes_and_resolve_match_jax(recipe):
    jr, tr = jprec.resolve(recipe), tprec.resolve(recipe)
    assert (jr.name, jr.act, jr.weight, jr.quantized, jr.packed_weights) == \
        (tr.name, tr.act, tr.weight, tr.quantized, tr.packed_weights)
    assert tprec.resolve(None, "int8") == tprec.RECIPES["int8"]
    assert tlin.SparsityConfig(pattern=(6, 8), mode="compressed",
                               recipe=recipe).recipe is tprec.RECIPES[recipe]


@pytest.mark.parametrize("n", FAMILIES)
@pytest.mark.parametrize("recipe", RECIPES)
def test_pack_params_match_jax(n, recipe):
    """JAX ``pack_params`` on the JAX tree and the port's ``pack_params``
    on the carried-over tree give bit-equal values, indices and s_w."""
    base = jreg.smoke_config("h2o-danube-3-4b")
    z, l = 2 * n - 2, 2 * n
    jcfg = dataclasses.replace(base, sparsity=jlin.SparsityConfig(
        pattern=(z, l), mode="compressed", recipe=recipe))
    tcfg = dataclasses.replace(treg.smoke_config("h2o-danube-3-4b"),
                               sparsity=tlin.SparsityConfig(
                                   pattern=(z, l), mode="compressed",
                                   recipe=recipe))
    tree = jax.tree_util.tree_map(np.asarray,
                                  JM.init(jcfg, jax.random.PRNGKey(n)))
    jpacked = jax.tree_util.tree_map(np.asarray,
                                     jserve.pack_params(tree, jcfg))
    tpacked = tserve.pack_params(params_from_jax(tree, tcfg, device="cpu"),
                                  tcfg)
    names = ["wq", "wk", "wv", "wo"]
    pairs = [(jpacked["lm_head"], tpacked["lm_head"])]
    for u in range(tcfg.num_units):
        jl, tl = jpacked["units"]["layer_0"], tpacked["units"][u]["layer_0"]
        pairs += [(jax.tree_util.tree_map(lambda a: a[u], jl["mixer"][k]),
                   tl["mixer"][k]) for k in names]
        pairs += [(jax.tree_util.tree_map(lambda a: a[u], jl["ffn"][k]),
                   tl["ffn"][k]) for k in ("w_gate", "w_up", "w_down")]
    for jp, tp in pairs:
        assert set(jp) == set(tp)
        for key in jp:
            assert_bit_equal(jp[key], tp[key])
    assert_bit_equal(jpacked["embed"]["w"], tpacked["embed"]["w"])


def test_to_torch_bitcasts_bf16_and_fp8():
    x = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    assert_bit_equal(x, to_torch(x, device="cpu"))
    f = np.asarray(jnp.asarray([1.5, -448.0, 0.0], jnp.float8_e4m3fn))
    assert_bit_equal(f, to_torch(f, device="cpu"))


@pytest.mark.parametrize("convert", ["to_torch", "params_from_jax"])
def test_convert_defaults_to_the_card(monkeypatch, convert):
    """Like every entry point of the port, the weight converters put their
    tensors on the card unless a device is named, and raise where there is
    no CUDA rather than run on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"embed": {"w": np.zeros((4, 2), np.float32)},
            "units": {"w": np.zeros((1, 2), np.float32)}}
    cfg = dataclasses.make_dataclass("Cfg", [("num_units", int)])(1)
    call = ((lambda **kw: to_torch(tree["embed"]["w"], **kw))
            if convert == "to_torch"
            else (lambda **kw: params_from_jax(tree, cfg, **kw)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    out = call(device="cpu")
    leaf = out if convert == "to_torch" else out["units"][0]["w"]
    assert leaf.device.type == "cpu"
