"""The dataflows of the port's dense quantized matmul (B5) and quant+lift
(B4) kernels, held against the Pallas kernels they replace, run in
interpret mode on the CPU, and their launch plans as pure functions of
the shapes.

* B5 ``ref.quant_matmul_split``: the contraction cut into the kernel's
  shares (``quant_matmul.share_for``), partial dots summed in split order,
  then the epilogue; K a multiple of 6, 8 and 16, one to three splits.
  int8 is bit-exact against ``quant_matmul_pallas(interpret=True)``
  without a bias, and against the JAX oracle ``repro.kernels.ref`` with
  one (the interpret-mode kernel fuses ``acc * s_w + bias`` into one FMA
  on the CPU; within 1e-6 of its output).  e4m3 operands (fp32 sums in
  another order) and SiLU (another sigmoid) within rtol = atol = 1e-5 of
  the output scale.
* B4 ``ref.fused_quant_slide_spans``: each block of a row's cluster takes
  the max over its span (``fused_quant_slide.spans``), the row's absmax
  the max of those; q bit-exact against ``fused_quant_slide_pallas(
  interpret=True)`` for N = 2, 3, 4, int8 and e4m3, with an all-zero row
  (the 1e-8 floor) and a row whose absmax lies in the last span; the
  scale bit-exact against the JAX oracle and within one ulp of the
  Pallas kernel (whose jit rewrites ``a / 127`` as ``a * (1 / 127)``).
* ``quant_matmul.splits_for`` and ``fused_quant_slide.launch_plan``.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.core.patterns import Pattern, SlideDecomposition, TWO_FOUR
from repro.kernels import fused_quant_slide as jfqs
from repro.kernels import quant_matmul as jqmm
from repro.kernels import ref as jref

from repro_torch.convert import to_torch
from repro_torch.kernels import fused_quant_slide as tfqs
from repro_torch.kernels import quant_matmul as tqmm
from repro_torch.kernels import ref


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float8_e4m3fn:
            a = a.view(torch.uint8)
        return np.ascontiguousarray(a.cpu().numpy()).view(np.uint8)
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _seed(key) -> int:
    return zlib.crc32(repr(key).encode())


# ---------------------------------------------------------------- B5
@pytest.mark.parametrize("k", [36, 40, 48], ids=lambda k: f"K{k}")
@pytest.mark.parametrize("case", [
    ("int8", False, None), ("int8", True, None), ("int8", True, "silu"),
    ("fp8", True, "silu")],
    ids=lambda c: f"{c[0]}-{'bias' if c[1] else 'nobias'}-{c[2]}")
def test_quant_matmul_split_mirror_matches_pallas(case, k):
    xdt, with_bias, activation = case
    rng = np.random.default_rng(_seed((case, k)))
    rows, m = 5, 24
    x = rng.standard_normal((rows, k)).astype(np.float32)
    x *= np.exp(rng.uniform(-4, 4, size=(rows, 1))).astype(np.float32)
    w = rng.standard_normal((m, k)).astype(np.float32) * k ** -0.5
    bias = rng.standard_normal((m,)).astype(np.float32)
    jqx = (jq.quantize_fp8 if xdt == "fp8" else jq.quantize_int8)(
        jnp.asarray(x))
    jqw = jq.quantize_int8(jnp.asarray(w))
    t = {n_: to_torch(np.asarray(v), device="cpu") for n_, v in (
        ("qx", jqx.q), ("sx", jqx.scale), ("qw", jqw.q), ("sw", jqw.scale))}
    jb = jnp.asarray(bias) if with_bias else None
    tb = torch.from_numpy(bias) if with_bias else None
    want = np.asarray(jqmm.quant_matmul_pallas(
        jqx.q, jqw.q, jqx.scale, jqw.scale, jb, out_dtype=jnp.float32,
        interpret=True, bm=8, br=8, bk=16, activation=activation))
    whole = _np(ref.quant_matmul(t["qx"], t["sx"], t["qw"], t["sw"],
                                 torch.float32, tb, activation))
    shares = {tqmm.share_for(rows, k, s) for s in (1, 2, 3)}
    assert len(shares) == 3  # three split counts, each its own cut
    for share in sorted(shares):
        got = _np(ref.quant_matmul_split(t["qx"], t["sx"], t["qw"], t["sw"],
                                         share, torch.float32, tb,
                                         activation))
        if xdt == "int8" and activation is None:
            oracle = jref.epilogue(jref.quant_matmul(
                jqx.q, jqx.scale, jqw.q, jqw.scale, jnp.float32), jb, None)
            np.testing.assert_array_equal(got, np.asarray(oracle))
            np.testing.assert_array_equal(got, whole)
            if with_bias:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(got, want)
        else:
            tol = 1e-5 * float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)
            if xdt == "int8":  # integer partials: the split changes nothing
                np.testing.assert_array_equal(got, whole)


@pytest.mark.parametrize("shape", [
    # (R, M, K): the model's linears at decode and prefill, the B4 -> B5
    # pipeline's gamma*K, the ragged N = 2, 3 cases
    (1, 960, 3840), (4, 960, 3840), (4, 3840, 3840), (4, 32000, 3840),
    (16, 3840, 10240), (16, 3840, 15360), (8, 10240, 5120),
    (17, 960, 3840), (128, 3840, 3840), (128, 3840, 15360),
    (2048, 10240, 3840), (5, 37, 120), (40, 100, 64),
])
def test_quant_matmul_splits_cover_and_fit(shape):
    r, m, k = shape
    s = tqmm.splits_for(r, m, k)
    assert s == tqmm.splits_for(r, m, k) >= 1  # only the shapes decide
    share = tqmm.share_for(r, k, s)
    assert s * share >= k > (s - 1) * share  # covered, no empty split
    if r <= tqmm.DECODE_MAX_R:
        assert share % 16 == 0
        assert tqmm.decode_rows(r) * share <= tqmm.DEC_SMEM
        if -(-m // tqmm.DEC_WARPS) < tqmm.SMS and k >= 2 * tqmm.MIN_SHARE:
            assert s > 1  # idle SMs: the contraction is split
        if s > 1 and tqmm.decode_rows(r) * k <= tqmm.DEC_SMEM:
            assert share >= tqmm.MIN_SHARE
    else:
        assert share % tqmm.PREFILL_BK == 0
        stages = -(-k // tqmm.PREFILL_BK)
        assert s == 1 or stages // s >= tqmm.MIN_SPLIT_STAGES
        assert s <= tqmm.MAX_CLUSTER  # a tile's splits form one cluster
        tiles = -(-m // tqmm.PREFILL_TILE) * -(-r // tqmm.PREFILL_TILE)
        assert s == 1 or tiles * s <= tqmm.SMS  # one wave of blocks
        assert tqmm.prefill_stages(r, m) == (4 if tiles <= tqmm.SMS else 3)


# ---------------------------------------------------------------- B4
def _dec(n):
    return SlideDecomposition(Pattern.from_family(n), TWO_FOUR)


@pytest.mark.parametrize("rows", [4, 140])
@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_fused_quant_slide_spans_mirror_matches_pallas(n, fp8, rows):
    rng = np.random.default_rng(_seed((n, fp8, rows)))
    k = 2 * n * 28
    x = rng.standard_normal((rows, k)).astype(np.float32)
    x *= np.exp(rng.uniform(-5, 5, size=(rows, 1))).astype(np.float32)
    x[0] = 0.0                      # the 1e-8 floor
    x[1, -1] = 50.0 * np.abs(x[1]).max()  # absmax in the last span
    x[2, :4] = [127.0, 0.5, -1.5, 2.5]    # exact halves
    spans = tfqs.spans(rows, k, n)
    assert spans[0][0] == 0 and spans[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    if rows < tfqs.SMS:
        assert len(spans) > 1 and spans[-1][0] < k - 1  # a real last span
    jqv, js = jfqs.fused_quant_slide_pallas(jnp.asarray(x), n_fam=n,
                                            interpret=True, fp8=fp8)
    tqv, ts = ref.fused_quant_slide_spans(torch.from_numpy(x), _dec(n),
                                          spans, fp8=fp8)
    np.testing.assert_array_equal(_bits(jqv), _bits(tqv))
    np.testing.assert_array_max_ulp(np.asarray(js), _np(ts), maxulp=1)
    oq, os_ = jref.fused_quant_slide(jnp.asarray(x), _dec(n), fp8=fp8)
    np.testing.assert_array_equal(_bits(oq), _bits(tqv))
    np.testing.assert_array_equal(_bits(os_), _bits(ts))
    assert float(ts[0, 0]) == float(np.float32(1e-8) / np.float32(
        448.0 if fp8 else 127.0))


@pytest.mark.parametrize("shape", [
    # (R, K, N)
    (1, 3840, 4), (4, 3840, 4), (4, 10240, 4), (128, 3840, 4),
    (2048, 10240, 4), (4, 120, 3), (17, 48, 2), (300, 30720, 3),
])
def test_fused_quant_slide_launch_plan(shape):
    r, k, n = shape
    cluster, upb = tfqs.launch_plan(r, k, n)
    assert (cluster, upb) == tfqs.launch_plan(r, k, n)
    units = -(-k // (tfqs.UNIT_GROUPS[n] * 2 * n))
    assert 1 <= cluster <= tfqs.MAX_CLUSTER and 1 <= upb <= tfqs.MAX_THREADS
    assert cluster * upb >= units > (cluster - 1) * upb  # no idle block
    need = -(-units // tfqs.MAX_THREADS)  # blocks a row of units needs
    if r < tfqs.SMS:  # few rows: spread evenly over up to 8 blocks a row
        spread = min(tfqs.MAX_CLUSTER, -(-tfqs.SMS // r), units)
        assert upb <= -(-units // max(spread, need))
    else:
        assert cluster == need
