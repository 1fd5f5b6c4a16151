"""The port's cost model (``repro_torch.kernels.roofline``) held against
the JAX package's ``repro.kernels.roofline``.

Called with JAX's arguments every cost function, ``op_cost`` and
``tile_traffic`` returns JAX's value bit for bit, over a grid of shapes,
families (N = 2, 3, 4) and recipes; the port's width keywords price what
its kernels read and write (B1's weight stream is the bytes of the
port's compressed operand; bf16 activations and outputs).  The gather
counter of ``models.attention`` equals the ``pool_gather`` model and
JAX's counter on the same inputs.  Peaks: the binding term, the env
override, the H100's published rates on a CUDA device.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import roofline as jrl
from repro.models import attention as JA

from repro_torch.core import linear as tlin
from repro_torch.kernels import roofline as rl
from repro_torch.models import attention as TA

SHAPES = [(1, 48, 16), (4, 96, 40), (128, 384, 256), (333, 1152, 96)]
FAMILIES = (2, 3, 4)
RECIPES = ("int8", "fp8", "w4", "fp8w4")


def _eq(a, b):
    assert (a.bytes, a.flops) == (b.bytes, b.flops), (a, b)


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("REPRO_PEAK_BW_GBPS", "10.0")
    monkeypatch.setenv("REPRO_PEAK_GFLOPS", "100.0")
    rl.peaks(refresh=True)
    yield
    rl._PEAKS.clear()


@pytest.mark.parametrize("n_fam", FAMILIES)
def test_cost_functions_equal_jax(n_fam):
    """Every kernel cost function, lifted_k / compressed_k and itemsize,
    at JAX's arguments."""
    for rows, k, m in SHAPES:
        k = k - k % (2 * n_fam)
        assert rl.lifted_k(k, n_fam) == jrl.lifted_k(k, n_fam)
        assert rl.compressed_k(k, n_fam) == jrl.compressed_k(k, n_fam)
        _eq(rl.dense_gemm(rows, k, m), jrl.dense_gemm(rows, k, m))
        _eq(rl.dense_gemm(rows, k, m, 2.0, 1.0, 2.0),
            jrl.dense_gemm(rows, k, m, 2.0, 1.0, 2.0))
        _eq(rl.quant_matmul(rows, k, m), jrl.quant_matmul(rows, k, m))
        _eq(rl.quant_matmul(rows, k, m, 1.0, 0.5),
            jrl.quant_matmul(rows, k, m, 1.0, 0.5))
        _eq(rl.compressed_matmul(rows, k, m, n_fam),
            jrl.compressed_matmul(rows, k, m, n_fam))
        for rec in RECIPES:
            _eq(rl.fused_slided_matmul(rows, k, m, n_fam, rec),
                jrl.fused_slided_matmul(rows, k, m, n_fam, rec))
            _eq(rl.two_kernel(rows, k, m, n_fam, rec),
                jrl.two_kernel(rows, k, m, n_fam, rec))
            _eq(rl.compressed_matmul(rows, k, m, n_fam, rec),
                jrl.compressed_matmul(rows, k, m, n_fam, rec))
        for rec in ("int8", "fp8"):
            _eq(rl.fused_quant_slide(rows, k, n_fam, rec),
                jrl.fused_quant_slide(rows, k, n_fam, rec))
    for name in ("int8", "w4", "fp8", "bfloat16", "float32", "float16",
                 "float8_e4m3fn", "int4", "nope", None):
        assert rl.itemsize(name) == jrl.itemsize(name)


def test_attention_and_cow_costs_equal_jax():
    for b, kv, kvh, hd, qh, isz in itertools.product(
            (1, 3), (64, 500), (1, 8), (64, 120), (None, 32), (4.0, 1.0)):
        _eq(rl.paged_attention_decode(b, kv, kvh, hd, qh, isz),
            jrl.paged_attention_decode(b, kv, kvh, hd, qh, isz))
        for scales in (False, True):
            _eq(rl.paged_attention_decode(b, kv, kvh, hd, qh, isz, 1024,
                                          scales),
                jrl.paged_attention_decode(b, kv, kvh, hd, qh, isz, 1024,
                                           scales))
            _eq(rl.pool_gather(b, 1024, kvh, hd, isz, scales),
                jrl.pool_gather(b, 1024, kvh, hd, isz, scales))
        for lanes in (1, 4):
            _eq(rl.paged_attention_verify(b, kv, lanes, kvh, hd, qh, isz),
                jrl.paged_attention_verify(b, kv, lanes, kvh, hd, qh, isz))
            _eq(rl.paged_attention_verify(b, kv, lanes, kvh, hd, qh, isz,
                                          2048, True),
                jrl.paged_attention_verify(b, kv, lanes, kvh, hd, qh, isz,
                                           2048, True))
        _eq(rl.cow_copy(b, 16, kvh, hd, 24, isz),
            jrl.cow_copy(b, 16, kvh, hd, 24, isz))


OP_PARAMS = [
    ("fused_quant_slide", dict(pattern="6:8", dtype="float32", adt="int8")),
    ("fused_quant_slide", dict(pattern="4:6", dtype="float32", adt="fp8")),
    ("quant_matmul", dict(adt="int8", wdt="int8")),
    ("quant_matmul", dict(adt="float8_e4m3fn", wdt="float8_e4m3fn")),
    ("compressed_matmul", dict(pattern="6:8", adt="int8", wdt="int8")),
    ("compressed_matmul", dict(pattern="2:4", adt="fp8", wdt="w4")),
    ("compressed_matmul", dict(pattern="4:6", adt="float32",
                               wdt="float32")),
    ("fused_slided_matmul", dict(pattern="6:8", dtype="float32",
                                 adt="int8", wdt="int8")),
    ("fused_slided_matmul", dict(pattern="4:6", dtype="float32",
                                 adt="fp8", wdt="w4")),
    ("paged_attention", dict(adt="float32", lanes=4, kvh=2, hd=8, qh=4,
                             window=0)),
    ("paged_attention", dict(adt="int8", lanes=1, kvh=8, hd=120, qh=32,
                             window=300)),
    ("paged_attention", dict(adt="bfloat16")),
    ("op", dict(adt="int8")),
]


@pytest.mark.parametrize("op,params", OP_PARAMS,
                         ids=[f"{o}-{i}" for i, (o, _) in
                              enumerate(OP_PARAMS)])
def test_op_cost_and_tile_traffic_equal_jax(op, params):
    for rows, k, m in SHAPES:
        k = k - k % 24  # whole groups of every family here
        got = rl.op_cost(op, rows, m, k, **params)
        want = jrl.op_cost(op, rows, m, k, **params)
        if want is None:
            assert got is None
        else:
            _eq(got, want)
        for br, bm in itertools.product((None, 8, 64, 256), (None, 128)):
            assert rl.tile_traffic(op, rows, m, k, br, bm, **params) \
                == jrl.tile_traffic(op, rows, m, k, br, bm, **params)


def test_width_keywords_price_the_port_kernels():
    """xdt / odt in op_cost equal the explicit width keywords; with them
    at JAX's fp32 the costs are JAX's; bf16 in and out drop exactly the
    activation and output halves."""
    rows, k, m, n = 4, 3840, 960, 4
    got = rl.op_cost("fused_slided_matmul", rows, m, k, pattern="6:8",
                     xdt="bfloat16", adt="int8", wdt="int8",
                     odt="bfloat16")
    _eq(got, rl.fused_slided_matmul(rows, k, m, n, "int8", x_itemsize=2.0,
                                    out_itemsize=2.0))
    full = jrl.fused_slided_matmul(rows, k, m, n, "int8")
    assert full.bytes - got.bytes == rows * k * 2.0 + rows * m * 2.0
    got = rl.op_cost("compressed_matmul", rows, m, k, pattern="6:8",
                     adt="int8", wdt="int8", odt="bfloat16")
    _eq(got, rl.compressed_matmul(rows, k, m, n, "int8", out_itemsize=2.0))
    kc = rl.compressed_k(k, n)
    _eq(rl.compressed_matmul(rows, k, m, n, None, float_itemsize=2.0,
                             out_itemsize=2.0),
        rl.Cost(rows * k * 2.0 + rows * 4.0 + m * kc * 3.0 + m * 4.0
                + rows * m * 2.0, 2.0 * rows * k * m + 8.0 * m * kc))
    got = rl.op_cost("paged_attention", 4, 960, 1024, adt="bfloat16",
                     xdt="bfloat16", kvh=8, hd=120, qh=32)
    _eq(got, rl.paged_attention_decode(4, 1024, 8, 120, 32, 2.0,
                                       q_itemsize=2.0))


@pytest.mark.parametrize("recipe", ["int8", "fp8", "w4"])
@pytest.mark.parametrize("n_fam", FAMILIES)
def test_b1_weight_stream_is_the_compressed_operand(recipe, n_fam):
    """B1's weight-stream term, m * kc * (wb + 1) + m * 4, is the bytes of
    the port's compressed operand: values (nibble-packed for w4) + int8
    position ids + fp32 row scales."""
    l = 2 * n_fam
    m, k = 24, 8 * l
    cfg = tlin.SparsityConfig(pattern=(l - 2, l), mode="compressed",
                              recipe=recipe)
    gen = torch.Generator().manual_seed(n_fam)
    p = tlin.prepare(tlin.init(gen, k, m), cfg)
    stored = sum(p[n].numel() * p[n].element_size()
                 for n in ("values", "indices", "s_w"))
    rec = cfg.recipe
    wb = rl.itemsize(rec.weight)
    assert stored == m * rl.compressed_k(k, n_fam) * (wb + 1.0) + m * 4.0
    cost = rl.compressed_matmul(3, k, m, n_fam, recipe)
    xb = rl.itemsize(rec.act)
    assert cost.bytes == 3 * k * xb + 3 * 4.0 + stored + 3 * m * 4.0


@pytest.mark.parametrize("recipe", ["int8", "w4"])
@pytest.mark.parametrize("m,k", [(16, 48), (40, 96), (24, 3840)])
def test_b3_weight_stream_is_the_sparse_operand(recipe, m, k):
    """With ``wfmt="2:4"`` B3's weight term is the bytes of the port's
    2:4 operand (values + metadata words) + the fp32 row scales."""
    cfg = tlin.SparsityConfig(pattern=(6, 8), mode="slided", recipe=recipe)
    gen = torch.Generator().manual_seed(m)
    p = tlin.prepare(tlin.init(gen, k, m), cfg)
    stored = sum(p[n].numel() * p[n].element_size()
                 for n in ("sp_values", "sp_meta"))
    gk = rl.lifted_k(k, 4)
    assert rl.sparse24_bytes(m, gk, recipe == "w4") == stored
    wdt = cfg.recipe.weight
    cost = rl.op_cost("fused_slided_matmul", 2, m, k, pattern="6:8",
                      xdt="bfloat16", adt="int8", wdt=wdt, odt="bfloat16",
                      wfmt="2:4")
    assert cost.bytes == 2 * k * 2.0 + stored + m * 4.0 + 2 * m * 2.0
    # mma.sp does the two non-zero products of each window of 4
    assert cost.flops == 2.0 * 2 * (gk // 2) * m + 4.0 * 2 * k
    whole = rl.op_cost("fused_slided_matmul", 2, m, k, pattern="6:8",
                       xdt="bfloat16", adt="int8", wdt=wdt, odt="bfloat16")
    assert whole.flops == 2.0 * 2 * gk * m + 4.0 * 2 * k


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_gather_counter_equals_model_and_jax(kv_dtype):
    """``attention.gather_bytes`` after ``_pool_gather`` equals the
    ``pool_gather`` model and JAX's counter on the same pool and table,
    at the fp32 gather JAX runs and at the port's bf16."""
    b, maxp, P, kvh, hd, num_pages = 3, 5, 4, 2, 8, 17
    rng = np.random.default_rng(0)
    shape = (num_pages, P, kvh, hd)
    if kv_dtype == "int8":
        pool = {"k": rng.integers(-127, 128, size=shape).astype(np.int8),
                "v": rng.integers(-127, 128, size=shape).astype(np.int8),
                "k_scale": np.ones(shape[:3] + (1,), np.float32),
                "v_scale": np.ones(shape[:3] + (1,), np.float32)}
    else:
        pool = {"k": rng.normal(size=shape).astype(np.float32),
                "v": rng.normal(size=shape).astype(np.float32)}
    pt = rng.integers(0, num_pages, size=(b, maxp)).astype(np.int32)
    JA.reset_gather_bytes()
    TA.reset_gather_bytes()
    try:
        JA._pool_gather({n: jnp.asarray(v) for n, v in pool.items()},
                        jnp.asarray(pt), jnp.float32)
        tpool = {n: torch.from_numpy(v) for n, v in pool.items()}
        k, v = TA._pool_gather(tpool, torch.from_numpy(pt), torch.float32)
        model = rl.pool_gather(b, maxp * P, kvh, hd,
                               kv_itemsize=pool["k"].dtype.itemsize,
                               scales=kv_dtype == "int8")
        assert k.shape == (b, maxp * P, kvh, hd)
        assert TA.gather_bytes() == JA.gather_bytes() == model.bytes
        TA.reset_gather_bytes()
        TA._pool_gather(tpool, torch.from_numpy(pt), torch.bfloat16)
        assert TA.gather_bytes() == rl.pool_gather(
            b, maxp * P, kvh, hd, pool["k"].dtype.itemsize,
            kv_dtype == "int8", out_itemsize=2.0).bytes
    finally:
        JA.reset_gather_bytes()
        TA.reset_gather_bytes()


def test_roofline_us_takes_binding_term():
    p = rl.Peaks(bw_gbps=10.0, gflops=100.0)
    assert rl.roofline_us(rl.Cost(bytes=1e9, flops=0.0), p) == 1e5
    assert rl.roofline_us(rl.Cost(bytes=0.0, flops=1e11), p) == 1e6
    assert rl.bound_by(rl.Cost(bytes=1e9, flops=0.0), p) == "bytes"
    assert rl.bound_by(rl.Cost(bytes=0.0, flops=1e11), p) == "operations"
    assert rl.efficiency(rl.Cost(bytes=1e9, flops=0.0), 2e5, p) == 0.5
    assert rl.efficiency(rl.Cost(bytes=1e9), 0.0, p) == 0.0
    jp = jrl.Peaks(bw_gbps=10.0, gflops=100.0)
    for c in (rl.Cost(3e8, 7e9), rl.Cost(5e9, 1e10)):
        assert rl.roofline_us(c, p) == jrl.roofline_us(
            jrl.Cost(c.bytes, c.flops), jp)


def test_peaks_env_override(monkeypatch):
    monkeypatch.setenv("REPRO_PEAK_BW_GBPS", "123.0")
    monkeypatch.setenv("REPRO_PEAK_GFLOPS", "456.0")
    p = rl.peaks(refresh=True)
    assert (p.bw_gbps, p.gflops) == (123.0, 456.0)
    assert rl.peaks("int8") == p  # both pinned: every kind


def test_published_peaks_on_a_cuda_device(monkeypatch):
    """On a CUDA device ``peaks`` gives the H100 SXM data sheet's rates,
    the compute peak by operand type (bf16 without one); a pinned rate
    still overrides; the host calibration is not run."""
    monkeypatch.delenv("REPRO_PEAK_BW_GBPS")
    monkeypatch.delenv("REPRO_PEAK_GFLOPS")
    monkeypatch.setattr(rl, "_on_card", lambda: True)
    monkeypatch.setattr(rl, "measure_peaks", lambda: pytest.fail(
        "calibrated on the card"))
    rl.peaks(refresh=True)
    assert rl.peaks() == rl.Peaks(3350.0, 989e3)
    assert rl.peaks("int8").gflops == rl.peaks("fp8").gflops == 1979e3
    assert rl.peaks(torch.bfloat16).gflops == 989e3
    assert rl.peaks("float32").gflops == 67e3
    assert rl.peaks("nope") == rl.peaks("bfloat16")
    monkeypatch.setenv("REPRO_PEAK_BW_GBPS", "2000.0")
    assert rl.peaks("int8", refresh=True) == rl.Peaks(2000.0, 1979e3)


def test_host_calibration_off_the_card(monkeypatch):
    """Off the card ``peaks`` is JAX's numpy calibration, once a process
    (every kind reads the same host rates)."""
    monkeypatch.delenv("REPRO_PEAK_BW_GBPS")
    monkeypatch.delenv("REPRO_PEAK_GFLOPS")
    monkeypatch.setattr(rl, "_on_card", lambda: False)
    calls = []
    monkeypatch.setattr(rl, "measure_peaks", lambda: calls.append(1)
                        or rl.Peaks(12.0, 34.0))
    rl.peaks(refresh=True)
    assert rl.peaks() == rl.peaks("int8") == rl.Peaks(12.0, 34.0)
    assert calls == [1]
