"""The slided path of the port (``mode="slided"``) held against the JAX
package, and the plain versions of its three kernels held against the
Pallas kernels they replace, run in interpret mode on the CPU.

* B4 ``ref.fused_quant_slide`` against ``fused_quant_slide_pallas(
  interpret=True)``, int8 and e4m3, N in {2, 3, 4}: q bit-exact.  The
  scale is bit-exact against the JAX oracle ``repro.kernels.ref`` and
  within one ulp of the Pallas kernel, whose jit rewrites ``a / 127`` as
  ``a * (1 / 127)`` (ROADMAP C).
* B5 ``ref.quant_matmul`` against ``quant_matmul_pallas(interpret=True)``:
  int8 without bias bit-exact.  With a bias the interpret-mode kernel
  fuses ``acc * s_w + bias`` into one FMA on the CPU, so there the port is
  held bit-exact against the JAX oracle ``repro.kernels.ref`` and within
  1e-6 of the Pallas output.  e4m3 operands (fp32 sums in another order)
  and SiLU (another sigmoid) within rtol = atol = 1e-5 of the output scale.
* B3 ``ref.slided_matmul_quant`` against ``fused_slided_matmul_pallas(
  interpret=True)`` for int8, w4, fp8 and fp8w4 x {None, SiLU} x N in
  {2, 4}: int8 and w4 bit-exact against the JAX oracle, with and without
  a bias, and within 1e-6 of the Pallas output (its prologue scale comes
  from that same rewrite); the rest at B5's tolerances.
  The port's weights are the kernel's 2:4 operand; inverted, they equal
  JAX's ``w_slided`` bit for bit.
* ``linear.apply`` in ``mode="slided"`` against the JAX ``linear.apply``
  (its jnp path) for every recipe; prepared == lazy; and, a property of
  the port, slided == compressed bit for bit for int8 and w4.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linear as jlin, quant as jq, slide as jslide
from repro.core.patterns import Pattern, SlideDecomposition, TWO_FOUR
from repro.kernels import fused_quant_slide as jfqs
from repro.kernels import fused_slide_matmul as jfsm
from repro.kernels import quant_matmul as jqmm
from repro.kernels import ref as jref

from repro_torch.convert import to_torch
from repro_torch.core import linear as tlin, quant as tq, slide as tslide
from repro_torch.core.patterns import Pattern as TPattern
from repro_torch.kernels import fused_slide_matmul as tfsm, ops, ref

RECIPES = ["none", "int8", "fp8", "w4", "fp8w4"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def bits(a) -> np.ndarray:
    """Raw bytes of a JAX/numpy array or torch tensor, for exact compare."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float8_e4m3fn:
            a = a.view(torch.uint8)
        return np.ascontiguousarray(a.cpu().numpy()).view(np.uint8)
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def assert_bit_equal(j, t):
    assert tuple(np.shape(j)) == tuple(t.shape)
    np.testing.assert_array_equal(bits(j), bits(t))


def _seed(key) -> int:
    return zlib.crc32(repr(key).encode())


def _dec(n):
    return SlideDecomposition(Pattern.from_family(n), TWO_FOUR)


def _acts(rng, rows, k):
    """Rows over many magnitudes, an all-zero row and half-way values."""
    x = rng.standard_normal((rows, k)).astype(np.float32)
    x *= np.exp(rng.uniform(-5, 5, size=(rows, 1))).astype(np.float32)
    x[0] = 0.0
    x[1, :4] = [127.0, 0.5, -1.5, 2.5]  # absmax 127: exact halves
    return x


# ---------------------------------------------------------------- quantizer
def test_quantizer_quotients_are_ieee():
    """127 / a and a / 127 are IEEE quotients, as in JAX: torch's
    ``float / tensor`` (reciprocal times float) misses the last bit for
    many scales."""
    rng = np.random.default_rng(0)
    a = (np.abs(rng.standard_normal(1024))
         * np.exp(rng.uniform(-8, 8, 1024))).astype(np.float32)
    # each row: its absmax a, then values at x * (127 / a) ~ j + 0.5,
    # where one ulp of the reciprocal flips the rounding
    half = ((np.arange(127) + 0.5) / 127).astype(np.float32)
    x = np.concatenate([a[:, None], -a[:, None] * half[None, :]], axis=1)
    for jfn, tfn in ((jq.quantize_int8, tq.quantize_int8),
                     (jq.quantize_fp8, tq.quantize_fp8),
                     (jq.quantize_weight_int4_rowwise,
                      tq.quantize_weight_int4_rowwise)):
        jr, tr = jfn(jnp.asarray(x)), tfn(torch.from_numpy(x))
        assert_bit_equal(jr.q, tr.q)
        assert_bit_equal(jr.scale, tr.scale)
    got = tq.div(127.0, torch.from_numpy(a))
    assert_bit_equal(np.float32(127.0) / a, got)


# ---------------------------------------------------------------- B4
@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_fused_quant_slide_plain_matches_pallas(fp8, n):
    rng = np.random.default_rng(10 * n + fp8)
    x = _acts(rng, 9, 2 * n * 7)
    jqv, js = jfqs.fused_quant_slide_pallas(jnp.asarray(x), n_fam=n,
                                            interpret=True, fp8=fp8)
    tqv, ts = ref.fused_quant_slide(torch.from_numpy(x), _dec(n), fp8=fp8)
    assert_bit_equal(jqv, tqv)
    np.testing.assert_array_max_ulp(np.asarray(js), _np(ts), maxulp=1)
    oq, os_ = jref.fused_quant_slide(jnp.asarray(x), _dec(n), fp8=fp8)
    assert_bit_equal(oq, tqv)
    assert_bit_equal(os_, ts)
    # the pair-slice lift is the gather lift Psi
    q = ref.quantize_rows(torch.from_numpy(x), fp8).q
    assert_bit_equal(jslide.lift(jnp.asarray(_np(q.view(torch.uint8))),
                                 _dec(n)),
                     ref.lift_pairs(q, n))
    vq, vs = ops.fused_quant_slide(torch.from_numpy(x), _dec(n),
                                   recipe="fp8" if fp8 else "int8")
    assert_bit_equal(tqv, vq)
    assert_bit_equal(ts, vs)


# ---------------------------------------------------------------- B5
@pytest.mark.parametrize("case", [
    ("int8", "int8", False, None), ("int8", "int8", True, None),
    ("int8", "int8", True, "silu"), ("fp8", "int8", False, None),
    ("fp8", "int8", True, "silu"), ("fp8", "fp8", False, None)],
    ids=lambda c: f"{c[0]}x{c[1]}-{'bias' if c[2] else 'nobias'}-{c[3]}")
def test_quant_matmul_plain_matches_pallas(case):
    xdt, wdt, with_bias, activation = case
    rng = np.random.default_rng(_seed(case))
    rows, m, k = 5, 24, 40
    x = _acts(rng, rows, k)
    w = rng.standard_normal((m, k)).astype(np.float32) * k ** -0.5
    bias = rng.standard_normal((m,)).astype(np.float32)
    jqx = (jq.quantize_fp8 if xdt == "fp8" else jq.quantize_int8)(
        jnp.asarray(x))
    jqw = (jq.quantize_fp8 if wdt == "fp8" else jq.quantize_int8)(
        jnp.asarray(w))
    t = {n_: to_torch(np.asarray(v), device="cpu") for n_, v in (
        ("qx", jqx.q), ("sx", jqx.scale), ("qw", jqw.q), ("sw", jqw.scale))}
    jb = jnp.asarray(bias) if with_bias else None
    tb = torch.from_numpy(bias) if with_bias else None
    want = np.asarray(jqmm.quant_matmul_pallas(
        jqx.q, jqw.q, jqx.scale, jqw.scale, jb, out_dtype=jnp.float32,
        interpret=True, bm=8, br=8, bk=16, activation=activation))
    got = _np(ref.quant_matmul(t["qx"], t["sx"], t["qw"], t["sw"],
                               torch.float32, tb, activation))
    if xdt == wdt == "int8" and activation is None:
        oracle = jref.epilogue(jref.quant_matmul(
            jqx.q, jqx.scale, jqw.q, jqw.scale, jnp.float32), jb, None)
        np.testing.assert_array_equal(got, np.asarray(oracle))
        if with_bias:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
    else:
        tol = 1e-5 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)
    via_ops = ops.quant_matmul(t["qx"], t["sx"], t["qw"], t["sw"],
                               torch.float32, tb, activation)
    np.testing.assert_array_equal(_np(via_ops), got)


# ---------------------------------------------------------------- B3
def _slided_operands(recipe, n, seed, m=40, groups=6):
    rng = np.random.default_rng(seed)
    k = 2 * n * groups
    w = rng.standard_normal((m, k)).astype(np.float32) * k ** -0.5
    x = _acts(rng, 5, k)
    bias = rng.standard_normal((m,)).astype(np.float32)
    z, l = 2 * n - 2, 2 * n
    jcfg = jlin.SparsityConfig(pattern=(z, l), mode="slided", recipe=recipe,
                               use_pallas=False)
    tcfg = tlin.SparsityConfig(pattern=(z, l), mode="slided", recipe=recipe)
    return w, x, bias, jcfg, tcfg


@pytest.mark.parametrize("recipe", ["int8", "w4", "fp8", "fp8w4"])
@pytest.mark.parametrize("activation", [None, "silu"])
@pytest.mark.parametrize("n", [2, 4])
def test_slided_matmul_plain_matches_pallas(recipe, activation, n):
    w, x, bias, jcfg, tcfg = _slided_operands(
        recipe, n, _seed((recipe, activation, n)))
    jp = jlin.prepare({"w": jnp.asarray(w)}, jcfg)
    tp = tlin.prepare({"w": torch.from_numpy(w)}, tcfg)
    # the port stores Phi(W) as the kernel's 2:4 operand; inverted, it is
    # JAX's slided matrix bit for bit
    assert set(jp) == {"w_slided", "s_w"}
    assert set(tp) == {"sp_values", "sp_meta", "s_w"}
    assert_bit_equal(jp["s_w"], tp["s_w"])
    rec = tcfg.recipe
    dec = tcfg.decomposition()
    gk = tfsm.lifted_width(w.shape[1], n)
    assert_bit_equal(jp["w_slided"], tfsm.dense_from_operand(
        tp["sp_values"], tp["sp_meta"], w.shape[0], gk,
        packed=rec.packed_weights))
    tx, tb, jx = torch.from_numpy(x), torch.from_numpy(bias), jnp.asarray(x)

    def pallas(b):
        return np.asarray(jfsm.fused_slided_matmul_pallas(
            jx, jp["w_slided"], jp["s_w"], b, n_fam=n,
            out_dtype=jnp.float32, interpret=True, activation=activation,
            act=rec.act, w4=rec.packed_weights))

    def port(b):
        return _np(ref.slided_matmul_sparse(tx, tp["sp_values"],
                                            tp["sp_meta"], tp["s_w"], dec,
                                            recipe, torch.float32, bias=b,
                                            activation=activation))

    got, want = port(tb), pallas(jnp.asarray(bias))
    if recipe in ("int8", "w4") and activation is None:
        for b in (None, bias):
            oracle = jref.slided_matmul_quant(
                jx, jp["w_slided"], jp["s_w"], jcfg.decomposition(), recipe,
                jnp.float32, bias=None if b is None else jnp.asarray(b))
            np.testing.assert_array_equal(
                port(None if b is None else tb), np.asarray(oracle))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        tol = 1e-5 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)
    via_ops = ops.slided_matmul_quant(tx, tp["sp_values"], tp["sp_meta"],
                                      tp["s_w"], dec, recipe, torch.float32,
                                      bias=tb, activation=activation)
    np.testing.assert_array_equal(_np(via_ops), got)


# ---------------------------------------------------------------- linear
@pytest.mark.parametrize("recipe", RECIPES)
@pytest.mark.parametrize("n", [2, 4])
def test_linear_slided_matches_jax(recipe, n):
    w, x, _, jcfg, tcfg = _slided_operands(recipe, n, 7 * n)
    x3 = x.reshape(1, 5, -1)  # a leading batch axis, as the model passes
    want = np.asarray(jlin.apply({"w": jnp.asarray(w)}, jnp.asarray(x3),
                                 jcfg))
    tw = {"w": torch.from_numpy(w)}
    got = tlin.apply(tw, torch.from_numpy(x3), tcfg)
    prepared = tlin.prepare(tw, tcfg)
    assert "w" not in prepared
    assert set(prepared) == ({"w_slided"} if recipe == "none"
                             else {"sp_values", "sp_meta", "s_w"})
    np.testing.assert_array_equal(
        _np(tlin.apply(prepared, torch.from_numpy(x3), tcfg)), _np(got))
    if recipe in ("int8", "w4"):
        np.testing.assert_array_equal(_np(got), want)
    else:  # fp32 sums in another order
        tol = 1e-5 * float(np.abs(want).max())
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=tol)
    # the plain slided product is Psi(x) @ Phi(W)^T, as in JAX
    if recipe == "none":
        ws = prepared["w_slided"]
        np.testing.assert_allclose(
            _np(tslide.slided_matmul(torch.from_numpy(x), ws, tcfg.decomposition())),
            np.asarray(jslide.slided_matmul(jnp.asarray(x), jnp.asarray(_np(ws)),
                                            jcfg.decomposition())),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("recipe", ["int8", "w4"])
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("activation", [None, "silu"])
def test_slided_equals_compressed_bitwise(recipe, n, activation):
    """Phi keeps each kept weight exactly once, so for integer recipes the
    slided and compressed linears sum the same integer products."""
    w, x, _, _, scfg = _slided_operands(recipe, n, 100 + n)
    ccfg = tlin.SparsityConfig(pattern=scfg.pattern, mode="compressed",
                               recipe=recipe)
    tw, tx = {"w": torch.from_numpy(w)}, torch.from_numpy(x)
    ys = tlin.apply(tw, tx, scfg, activation=activation)
    yc = tlin.apply(tw, tx, ccfg, activation=activation)
    assert torch.equal(ys, yc)
    assert tslide.decomposition_for(TPattern(*scfg.pattern)) == \
        scfg.decomposition()
