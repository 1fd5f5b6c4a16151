"""Plain versions of the port's two kernels held against the Pallas kernels
they replace, run in interpret mode on the CPU.

* B1 ``ref.compressed_matmul_{quant,fp}`` against
  ``slide_matmul.compressed_matmul_pallas(interpret=True)``: int8 and w4
  bit-exact (int32 accumulation, the same epilogue op order).  With a bias
  the interpret-mode kernel fuses ``acc * s_w + bias`` into one FMA on
  the CPU, so there the port is held bit-exact against the JAX oracle
  ``repro.kernels.ref`` (separate multiply and add, as the CUDA kernel
  does) and within 1e-6 of the Pallas output.  The fp32 float path, fp8
  (fp32 accumulation in another order) and SiLU (another sigmoid) agree
  within rtol = atol = 1e-5 of the output scale.
* B2 ``ref.flash_paged`` against ``paged_attention._flash_pallas(
  interpret=True)`` for decode and prefill-chunk lanes, fp32 and int8 pools,
  window on and off, GQA rep > 1 and head_dim 24: atol = rtol = 1e-5, since
  online softmax reassociates its sums.
* B2's split dataflow ``ref.flash_paged_split`` (what the CUDA kernel
  computes at its own split count) against ``_flash_pallas(splits=s,
  interpret=True)`` for s in 1..4, with tables whose tails are
  unallocated, so some splits see no position; the wrapper's split
  chooser and B1's launch plan as pure functions of shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linear as jlin, precision as jprec
from repro.core.compressed import CompressedSlided as JCompressed
from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro.kernels import slide_matmul as jsm

from repro_torch.convert import to_torch
from repro_torch.core import linear as tlin
from repro_torch.core.compressed import CompressedSlided as TCompressed
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import slide_matmul as tsm
from repro_torch.kernels import fused_quant_slide as tfqs
from repro_torch.kernels import fused_slide_matmul as tfsm
from repro_torch.kernels import quant_matmul as tqmm


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------- B1
@pytest.mark.parametrize("recipe", ["none", "int8", "fp8", "w4"])
@pytest.mark.parametrize("activation", [None, "silu"])
@pytest.mark.parametrize("n", [2, 4])
def test_compressed_matmul_plain_matches_pallas(recipe, activation, n):
    rng = np.random.default_rng(hash((recipe, activation, n)) % 2**32)
    rows, m, k = 5, 40, 2 * n * 6
    w = rng.standard_normal((m, k)).astype(np.float32) * k ** -0.5
    x = rng.standard_normal((rows, k)).astype(np.float32)
    bias = rng.standard_normal((m,)).astype(np.float32)
    z, l = 2 * n - 2, 2 * n
    jcfg = jlin.SparsityConfig(pattern=(z, l), mode="compressed",
                               recipe=recipe)
    tcfg = tlin.SparsityConfig(pattern=(z, l), mode="compressed",
                               recipe=recipe)
    jp = jlin.prepare({"w": jnp.asarray(w)}, jcfg)
    tp = {key: to_torch(np.asarray(v), device="cpu")
          for key, v in jp.items()}
    rec = jprec.resolve(recipe)
    jc = JCompressed(jp["values"], jp["indices"], k, z, l, 2, 4,
                     packed=rec.packed_weights)
    tc = TCompressed(tp["values"], tp["indices"], k, z, l, 2, 4,
                     packed=rec.packed_weights)
    tx, tb = torch.from_numpy(x), torch.from_numpy(bias)

    def pallas(b):
        if not rec.quantized:
            return np.asarray(jsm.compressed_matmul(
                jnp.asarray(x), jc, bias=b, out_dtype=jnp.float32,
                interpret=True, activation=activation))
        qx = rec.quantize_act(jnp.asarray(x))
        return np.asarray(jsm.compressed_matmul(
            qx.q, jc, s_x=qx.scale, s_w=jp["s_w"], bias=b,
            out_dtype=jnp.float32, interpret=True, activation=activation))

    def port(b):
        if not rec.quantized:
            return _np(ref.compressed_matmul_fp(tx, tc, torch.float32, bias=b,
                                                activation=activation))
        return _np(ref.compressed_matmul_quant(tx, tc, tp["s_w"], recipe,
                                               torch.float32, bias=b,
                                               activation=activation))

    got, want = port(tb), pallas(jnp.asarray(bias))
    if recipe in ("int8", "w4") and activation is None:
        np.testing.assert_array_equal(port(None), pallas(None))
        oracle = jref.compressed_matmul_quant(
            jnp.asarray(x), jc, jp["s_w"], recipe, jnp.float32,
            bias=jnp.asarray(bias))
        np.testing.assert_array_equal(got, np.asarray(oracle))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        tol = 1e-5 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)
    # the dispatcher sends a CPU tensor to exactly this plain version
    via_ops = ops.compressed_matmul(tx, tc, s_w=tp.get("s_w"), recipe=recipe,
                                    bias=tb, activation=activation)
    np.testing.assert_array_equal(_np(via_ops), got)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: never a silent plain run."""
    x = torch.zeros((2, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsm.compressed_matmul_cuda(x, torch.zeros((4, 6), dtype=torch.int8),
                                   torch.zeros((4, 6), dtype=torch.int8),
                                   None, None, n_fam=4)
    q = torch.zeros((1, 1, 2, 8))
    pool = {"k": torch.zeros((2, 4, 1, 8)), "v": torch.zeros((2, 4, 1, 8))}
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpa.paged_attention_cuda(q, pool, torch.zeros((1, 2), dtype=torch.int32),
                                 torch.ones((1,), dtype=torch.int32), None)
    xf = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfsm.fused_slided_matmul_cuda(
            xf, *tfsm.sparse_operand(torch.zeros((4, 12), dtype=torch.int8)),
            torch.ones((4, 1)), n_fam=4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfqs.fused_quant_slide_cuda(xf, n_fam=4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tqmm.quant_matmul_cuda(x, torch.ones((2, 1)),
                               torch.zeros((4, 8), dtype=torch.int8),
                               torch.ones((4, 1)))
    assert tsm.launch_count() == 0 and tpa.launch_count() == 0
    assert tfsm.launch_count() == tfqs.launch_count() == \
        tqmm.launch_count() == 0


# ---------------------------------------------------------------- B2
def _pool(rng, num_pages, page_size, kvh, hd, quant):
    shape = (num_pages, page_size, kvh, hd)
    if not quant:
        return {"k": rng.standard_normal(shape).astype(np.float32),
                "v": rng.standard_normal(shape).astype(np.float32)}
    sshape = (num_pages, page_size, kvh, 1)
    return {"k": rng.integers(-127, 128, shape).astype(np.int8),
            "v": rng.integers(-127, 128, shape).astype(np.int8),
            "k_scale": rng.uniform(0.001, 0.02, sshape).astype(np.float32),
            "v_scale": rng.uniform(0.001, 0.02, sshape).astype(np.float32)}


@pytest.mark.parametrize("lanes", [1, 6])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [None, 7])
def test_flash_paged_plain_matches_pallas(lanes, quant, window):
    rng = np.random.default_rng(100 * lanes + 10 * quant + (window or 0))
    b, h, kvh, hd, page_size, maxp, num_pages = 3, 4, 2, 24, 4, 6, 20
    pool = _pool(rng, num_pages, page_size, kvh, hd, quant)
    kv_len = np.array([1, 9, 19 - lanes], np.int32)  # row-0 lengths
    table = np.zeros((b, maxp), np.int32)            # unallocated -> page 0
    perm = rng.permutation(np.arange(1, num_pages))
    used = 0
    for i in range(b):
        n = -(-(kv_len[i] + lanes - 1) // page_size)
        table[i, :n] = perm[used:used + n]
        used += n
    q = rng.standard_normal((b, lanes, h, hd)).astype(np.float32)
    want = jpa._flash_pallas(jnp.asarray(q),
                             {k_: jnp.asarray(v) for k_, v in pool.items()},
                             jnp.asarray(table), jnp.asarray(kv_len), window,
                             splits=2, interpret=True)
    tpool = {k_: torch.from_numpy(v) for k_, v in pool.items()}
    got = ref.flash_paged(torch.from_numpy(q), tpool, torch.from_numpy(table),
                          torch.from_numpy(kv_len), window, block_pages=2)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    via_ops = ops.paged_attention(torch.from_numpy(q), tpool,
                                  torch.from_numpy(table),
                                  torch.from_numpy(kv_len),
                                  sliding_window=window)
    np.testing.assert_allclose(_np(via_ops), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# B2's split dataflow: ref.flash_paged_split is what the CUDA kernel
# computes at its own split count.  Tolerance atol = rtol = 1e-5 (bf16
# pools: the same, both sides widen the same bf16 values to fp32): online
# softmax reassociates its sums, and page-by-page folding in another
# order rounds differently.
@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("lanes", [1, 6])
@pytest.mark.parametrize("pool_kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("window", [None, 7])
def test_flash_paged_split_matches_pallas(splits, lanes, pool_kind, window):
    rng = np.random.default_rng(1000 * splits + 100 * lanes
                                + 10 * len(pool_kind) + (window or 0))
    # maxp = 8 pages of 4 against at most 19 tokens: every table's tail is
    # unallocated (page 0), so the last splits see no position at all
    b, h, kvh, hd, page_size, maxp, num_pages = 3, 4, 2, 24, 4, 8, 24
    pool = _pool(rng, num_pages, page_size, kvh, hd, pool_kind == "int8")
    if pool_kind == "bf16":
        pool = {k_: np.asarray(jnp.asarray(v, jnp.bfloat16))
                for k_, v in pool.items()}
    kv_len = np.array([1, 9, 19 - lanes], np.int32)
    table = np.zeros((b, maxp), np.int32)
    perm = rng.permutation(np.arange(1, num_pages))
    used = 0
    for i in range(b):
        n = -(-(kv_len[i] + lanes - 1) // page_size)
        table[i, :n] = perm[used:used + n]
        used += n
    q = rng.standard_normal((b, lanes, h, hd)).astype(np.float32)
    want = jpa._flash_pallas(jnp.asarray(q),
                             {k_: jnp.asarray(v) for k_, v in pool.items()},
                             jnp.asarray(table), jnp.asarray(kv_len), window,
                             splits=splits, interpret=True)
    tpool = {k_: to_torch(v, device="cpu") for k_, v in pool.items()}
    got = ref.flash_paged_split(torch.from_numpy(q), tpool,
                                torch.from_numpy(table),
                                torch.from_numpy(kv_len), window, splits)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [
    # (B, KVH, maxp, page_size, lanes, rep)
    (4, 8, 65, 16, 1, 4),      # chip_smoke decode: ~1000 tokens
    (4, 8, 21, 16, 1, 4),      # the engine's decode step
    (1, 8, 26, 16, 128, 4),    # a 128-lane prefill chunk
    (1, 1, 1, 16, 1, 1),       # one page
    (64, 8, 256, 16, 1, 4),    # enough blocks without a split
    (2, 2, 300, 1, 1, 8),      # page size 1
])
def test_split_chooser_is_a_pure_function_of_shapes(shape):
    b, kvh, maxp, page_size, lanes, rep = shape
    s = tpa.splits_for(*shape)
    assert s == tpa.splits_for(*shape)  # nothing but the shapes decides
    assert 1 <= s <= tpa.MAX_SPLITS
    pps = -(-maxp // s)
    assert pps >= 1 and (s - 1) * pps < maxp + pps  # every split has pages
    if s > 1:  # a split keeps at least MIN_SPLIT_TOKENS of the table
        assert (maxp // s) * page_size >= tpa.MIN_SPLIT_TOKENS
    blocks = b * kvh * -(-(lanes * rep) // tpa.ROW_TILE)
    if blocks >= tpa.BLOCKS_PER_SM * tpa.SMS:
        assert s == 1


@pytest.mark.parametrize("shape", [
    # (R, M, K, N)
    (4, 3840, 3840, 4), (16, 960, 3840, 4), (17, 960, 3840, 4),
    (128, 3840, 10240, 4), (128, 32000, 3840, 4), (40, 37, 120, 2),
    (300, 100, 48, 3),
])
def test_compressed_matmul_instances_and_decompress_count(shape):
    """B1's launcher plan as a pure function of shapes: the int8/w4 decode
    instance (R <= DECODE_MAX_R) decompresses no tile; the prefill instance
    each (PF_BM x stage) tile once per PF_BR activation rows, whatever the
    split of K; the float path once per row block."""
    r, m, k, n = shape
    splits = tsm.prefill_splits(r, m, k, n)
    assert splits == tsm.prefill_splits(r, m, k, n) >= 1
    stages = -(-k // tsm.prefill_stage(n))
    assert splits == 1 or stages // splits >= tsm.MIN_SPLIT_STAGES
    tiles = tsm.decompressed_tiles(r, m, k, n, integer=True)
    if r <= tsm.DECODE_MAX_R:
        assert tiles == 0
    else:
        assert tiles == -(-m // tsm.PF_BM) * stages * -(-r // tsm.PF_BR)
    assert tsm.decompressed_tiles(r, m, k, n, integer=False) > 0
