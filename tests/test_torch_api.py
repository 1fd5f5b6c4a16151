"""The port's public library API held against ``repro``'s, on the CPU.

* The core helpers bit-exact to JAX on the same seeded numpy inputs:
  ``unslide`` (and ``unslide(pack_slided(w)) == w``, N = 2, 3, 4; fp32,
  bf16, int8), ``pack_slided_ref`` (also == ``pack_slided``),
  ``is_hw_compliant``, ``pattern_violations``, ``dequantize``,
  ``int8_matmul_dequant``, ``CompressedSlided.nbytes_*``, the recipes'
  ``act_dtype`` / ``acc_dtype``, and the legacy names
  ``ref.compressed_matmul_int8``, ``ref.slided_matmul_int8`` and
  ``ops.slided_matmul_int8`` (its plain version on the CPU).
* ``unslid_matmul`` and ``dense_matmul``: exact on integer-valued fp32
  inputs; within FP32_RTOL of JAX's otherwise.
* Every name each ``repro.<package>/__init__.py`` imports exists in
  ``repro_torch.<package>`` (the kernels' Pallas names through
  ``PALLAS``), a module where JAX's is a module.
* Each ``repro_torch.<package>`` imports first in a fresh process, with
  ``jax`` and ``repro`` blocked.
"""
import ast
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import compressed as jcomp, packer as jpk, precision as jprec
from repro.core import quant as jq, slide as jslide
from repro.core.patterns import Pattern, SlideDecomposition, TWO_FOUR
from repro.kernels import ref as jref

from repro_torch.core import compressed as tcomp, packer as tpk
from repro_torch.core import precision as tprec, quant as tq, slide as tslide
from repro_torch.kernels import ops as tops, ref as tref

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = [2, 3, 4]
PACKAGES = ["core", "configs", "data", "kernels", "launch", "models", "optim",
            "checkpoint", "runtime", "sharding"]
# |port - JAX| / max|JAX| of a float product over K = 96: the two sum the
# same fp32 products in another order (oneDNN vs XLA's dot), a few ulps
FP32_RTOL = 1e-6
# ``repro.kernels``' Pallas names -> what stands for each in
# ``repro_torch.kernels`` (a dotted path), or None where the helper lives
# inside a CUDA source (``decompress_tile``: csrc/compressed_matmul.cu)
PALLAS = {"fused_quant_slide_pallas": "fused_quant_slide_cuda",
          "fused_slided_matmul_pallas": "fused_slided_matmul_cuda",
          "compressed_matmul_pallas": "compressed_matmul_cuda",
          "quant_matmul_pallas": "quant_matmul_cuda",
          "decompress_tile": None,
          "reset_decompress_count": "slide_matmul.reset_counts"}


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            a = a.view(torch.int16 if a.dtype == torch.bfloat16
                       else torch.int8)
        return a.numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def assert_bit_equal(j, t):
    assert tuple(np.shape(j)) == tuple(t.shape)
    np.testing.assert_array_equal(bits(j), bits(t))


def _dec(n):
    return SlideDecomposition(Pattern.from_family(n), TWO_FOUR)


def _carry(a: np.ndarray) -> torch.Tensor:
    """A numpy array (bf16 through ml_dtypes) as a CPU tensor, bit for
    bit."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _sparse(rng, n, dtype=np.float32, rows=6, groups=5, leading=()):
    """Z:L-pruned weights of ``dtype`` (integer-valued, so every dtype
    holds them exactly), with zeros of their own beside the pruned ones."""
    w = rng.integers(-9, 10, size=leading + (rows, 2 * n * groups))
    w = np.asarray(jpk.prune_to_pattern(jnp.asarray(w, jnp.float32),
                                        _dec(n).source))
    return w.astype(dtype)  # a writable copy


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16, np.int8],
                         ids=["fp32", "bf16", "int8"])
@pytest.mark.parametrize("n", FAMILIES)
def test_unslide_and_pack_slided_ref_match_jax(n, dtype):
    dec = _dec(n)
    w = _sparse(np.random.default_rng(n), n, dtype, leading=(2,))
    ws = np.asarray(jpk.pack_slided(jnp.asarray(w), dec))
    tws = tpk.pack_slided(_carry(w), dec)
    assert_bit_equal(ws, tws)
    back = tpk.unslide(tws, dec)
    assert_bit_equal(jpk.unslide(jnp.asarray(ws), dec), back)
    assert_bit_equal(w, back)
    ref = tpk.pack_slided_ref(w, dec)
    assert ref.dtype == w.dtype
    assert_bit_equal(jpk.pack_slided_ref(w, dec), _carry(ref))
    assert_bit_equal(ref, tws)


@pytest.mark.parametrize("n", FAMILIES)
def test_compliance_checks_match_jax(n):
    dec = _dec(n)
    rng = np.random.default_rng(20 + n)
    w = _sparse(rng, n)
    ws = np.asarray(jpk.pack_slided(jnp.asarray(w), dec))
    dense = rng.integers(1, 5, size=w.shape).astype(np.float32)
    bad_ws = ws.copy()
    bad_ws[0, :4] = 1.0                     # one window of 4 non-zeros
    for a in (ws.copy(), bad_ws):
        want = jpk.is_hw_compliant(a, dec)
        for got in (tpk.is_hw_compliant(a, dec),
                    tpk.is_hw_compliant(torch.from_numpy(a), dec),
                    tpk.is_hw_compliant(torch.from_numpy(a).to(
                        torch.bfloat16), dec)):
            assert type(got) is bool and got == want
    assert tpk.is_hw_compliant(ws, dec) and not tpk.is_hw_compliant(bad_ws,
                                                                     dec)
    for a in (w, dense, np.zeros_like(w)):
        want = jpk.pattern_violations(a, dec.source)
        for got in (tpk.pattern_violations(a, dec.source),
                    tpk.pattern_violations(torch.from_numpy(a), dec.source)):
            assert type(got) is int and got == want
    assert tpk.pattern_violations(dense, dec.source) == dense.size // (2 * n)


def _act(rng, rows=5, k=96):
    x = rng.standard_normal((rows, k)).astype(np.float32)
    x *= np.exp(rng.uniform(-3, 3, size=(rows, 1))).astype(np.float32)
    return x


@pytest.mark.parametrize("fp8", [False, True], ids=["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_matches_jax(fp8, dtype):
    x = _act(np.random.default_rng(3))
    jqx = (jq.quantize_fp8 if fp8 else jq.quantize_int8)(jnp.asarray(x))
    tqx = (tq.quantize_fp8 if fp8 else tq.quantize_int8)(torch.from_numpy(x))
    assert_bit_equal(jq.dequantize(jqx, getattr(jnp, dtype)),
                     tq.dequantize(tqx, getattr(torch, dtype)))
    assert tq.dequantize(tqx).dtype == torch.float32


def test_int8_matmul_dequant_matches_jax():
    rng = np.random.default_rng(4)
    x, w = _act(rng), rng.standard_normal((12, 96)).astype(np.float32)
    jr = jq.int8_matmul_dequant(jq.quantize_int8(jnp.asarray(x)),
                                jq.quantize_weight_int8_rowwise(
                                    jnp.asarray(w)))
    tr = tq.int8_matmul_dequant(tq.quantize_int8(torch.from_numpy(x)),
                                tq.quantize_weight_int8_rowwise(
                                    torch.from_numpy(w)))
    assert_bit_equal(jr, tr)
    assert tq.int8_matmul_dequant is tq.matmul_dequant


def _compressed(n, packed, rng):
    """JAX's and the port's CompressedSlided of the same weights (int4
    range when ``packed``)."""
    dec = _dec(n)
    w = _sparse(rng, n, rows=7)
    if packed:
        w = np.clip(w, -7, 7).astype(np.int8)
    jc = jcomp.compress(jpk.pack_slided(jnp.asarray(w), dec), dec,
                        pack_values=packed)
    tc = tcomp.compress(tpk.pack_slided(torch.from_numpy(w), dec), dec,
                        pack_values=packed)
    return jc, tc


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n", FAMILIES)
def test_nbytes_match_jax(n, packed):
    jc, tc = _compressed(n, packed, np.random.default_rng(30 + n))
    assert (tc.nbytes_values, tc.nbytes_meta_packed) == \
        (jc.nbytes_values, jc.nbytes_meta_packed)
    assert type(tc.nbytes_values) is int


@pytest.mark.parametrize("recipe", ["int8", "fp8", "w4", "fp8w4"])
def test_act_and_acc_dtypes_match_jax(recipe):
    jr, tr = jprec.resolve(recipe), tprec.resolve(recipe)
    assert str(tr.act_dtype).removeprefix("torch.") == \
        jnp.dtype(jr.act_dtype).name
    assert str(tr.acc_dtype).removeprefix("torch.") == \
        jnp.dtype(jr.acc_dtype).name


@pytest.mark.parametrize("activation", [None, "silu"])
@pytest.mark.parametrize("n", FAMILIES)
def test_legacy_int8_names_match_jax(n, activation):
    """``ref.compressed_matmul_int8``, ``ref.slided_matmul_int8`` and
    ``ops.slided_matmul_int8`` (dense Phi(q_W) in, B3's operand built
    inside, its plain version on the CPU) bit-equal to JAX's
    ``ref.*_int8`` with a bias; with SiLU, bit-equal to the port's
    ``*_quant`` and within 1e-6 of JAX's (XLA's and torch's sigmoid
    differ by an ulp, as in tests/test_torch_slided.py)."""
    dec = _dec(n)
    rng = np.random.default_rng(40 + n)
    k = 2 * n * 8
    w = rng.standard_normal((21, k)).astype(np.float32)
    w = np.array(jpk.prune_to_pattern(jnp.asarray(w), dec.source))
    x = _act(rng, rows=6, k=k)
    bias = rng.standard_normal(21).astype(np.float32)
    jqw = jq.quantize_weight_int8_rowwise(jnp.asarray(w))
    tqw = tq.quantize_weight_int8_rowwise(torch.from_numpy(w))
    jws, tws = jpk.pack_slided(jqw.q, dec), tpk.pack_slided(tqw.q, dec)
    jc, tc = jcomp.compress(jws, dec), tcomp.compress(tws, dec)
    tx, tb = torch.from_numpy(x), torch.from_numpy(bias)
    jx, jb = jnp.asarray(x), jnp.asarray(bias)
    kw = {"bias": tb, "activation": activation}
    pairs = [
        (jref.compressed_matmul_int8(jx, jc, jqw.scale, bias=jb,
                                     activation=activation),
         tref.compressed_matmul_int8(tx, tc, tqw.scale, **kw),
         tref.compressed_matmul_quant(tx, tc, tqw.scale, "int8", **kw))]
    want = jref.slided_matmul_int8(jx, jws, jqw.scale, dec, bias=jb,
                                   activation=activation)
    port = tref.slided_matmul_quant(tx, tws, tqw.scale, dec, "int8", **kw)
    pairs += [(want, tref.slided_matmul_int8(tx, tws, tqw.scale, dec, **kw),
               port),
              (want, tops.slided_matmul_int8(
                  tx.reshape(2, 3, k), tws, tqw.scale, dec,
                  **kw).reshape(6, 21), port)]
    for want, got, own in pairs:
        assert_bit_equal(own, got)
        if activation is None:
            assert_bit_equal(want, got)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("integer", [True, False], ids=["exact", "fp32"])
@pytest.mark.parametrize("n", FAMILIES)
def test_unslid_and_dense_matmul_match_jax(n, integer):
    dec = _dec(n)
    rng = np.random.default_rng(50 + n)
    w = _sparse(rng, n, rows=9, groups=96 // (2 * n))
    x = rng.integers(-5, 6, size=(2, 4, 96)).astype(np.float32)
    if not integer:
        w = w * rng.standard_normal(w.shape).astype(np.float32)
        x = x + rng.standard_normal(x.shape).astype(np.float32)
    ws = jpk.pack_slided(jnp.asarray(w), dec)
    tw = torch.from_numpy(np.array(ws))
    for want, got in (
            (jslide.unslid_matmul(jnp.asarray(x), ws, dec),
             tslide.unslid_matmul(torch.from_numpy(x), tw, dec)),
            (jslide.dense_matmul(jnp.asarray(x), jnp.asarray(w)),
             tslide.dense_matmul(torch.from_numpy(x), torch.from_numpy(w)))):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        if integer:  # |sums| < 2^24: exact in any order
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            err = np.abs(got.numpy() - want).max()
            assert err <= FP32_RTOL * np.abs(want).max(), err


def _exports(pkg: str) -> list[str]:
    """The names ``src/repro/<pkg>/__init__.py`` imports (its exports)."""
    tree = ast.parse((ROOT / "src" / "repro" / pkg / "__init__.py")
                     .read_text())
    return [a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names]


def _resolve(obj, dotted: str):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_match_jax(pkg):
    import importlib
    jmod = importlib.import_module(f"repro.{pkg}")
    tmod = importlib.import_module(f"repro_torch.{pkg}")
    names = _exports(pkg)
    assert names, pkg
    for name in names:
        if pkg == "kernels" and name in PALLAS:
            if PALLAS[name] is not None:
                assert callable(_resolve(tmod, PALLAS[name])), name
            continue
        got = getattr(tmod, name, None)
        assert got is not None, f"repro_torch.{pkg} lacks {name}"
        want = getattr(jmod, name)
        assert isinstance(got, type(sys)) == isinstance(want, type(sys)), \
            name
        assert callable(got) == callable(want), name


_BLOCKED_IMPORT = """
import importlib, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Block())
importlib.import_module(sys.argv[1])
print("ok")
"""


@pytest.fixture(scope="module")
def fresh_imports():
    """Every ``repro_torch.<package>`` imported first, each in a process
    of its own (all started together), with JAX and ``repro`` blocked:
    {package: (returncode, stdout, stderr)}."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", _BLOCKED_IMPORT, f"repro_torch.{pkg}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pkg in PACKAGES}
    out = {}
    for pkg, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        out[pkg] = (proc.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_imports_first_in_a_fresh_process(fresh_imports, pkg):
    rc, stdout, stderr = fresh_imports[pkg]
    assert rc == 0 and stdout.split() == ["ok"], stderr
