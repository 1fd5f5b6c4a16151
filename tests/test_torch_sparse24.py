"""The 2:4 form of Phi(W) in the port, held against the JAX package.

* ``pack_meta``, ``unpack_meta`` and ``decompress_slided`` of
  ``repro_torch.core.compressed`` bit-exact against ``repro.core.
  compressed`` for N in {2, 3, 4} x {int8, w4}.
* The fused kernel's operand (``fused_slide_matmul.sparse_operand``):
  its inverse gives Phi(W) back bit for bit, with planted windows holding
  one non-zero at each position 0-3, w4 and gamma*K not a multiple of 64;
  every window's pair of positions is strictly increasing (what
  ``mma.sp::ordered_metadata`` requires; JAX's ``compress`` orders
  non-zeros first, so a lone non-zero at p > 0 gives (p, 0)); and an
  independent reading of the operand as the m16n8k64 .s8 instruction
  reads its registers (the PTX ISA's fragment layouts) rebuilds Phi(W).
* The plain version on the operand (``ref.slided_matmul_sparse``) against
  ``fused_slided_matmul_pallas(interpret=True)``: int8 and w4 bit-exact
  against the JAX oracle and within 1e-6 of the Pallas output (its jit
  rewrites the prologue's ``a / 127``, ROADMAP C); e4m3 within
  rtol 1e-5, atol 1e-5 max|y| (fp32 sums in another order).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressed as jcomp, linear as jlin
from repro.core.patterns import Pattern, SlideDecomposition, TWO_FOUR
from repro.kernels import fused_slide_matmul as jfsm
from repro.kernels import ref as jref

from repro_torch.core import compressed as tcomp, linear as tlin, packer
from repro_torch.core import precision, slide
from repro_torch.core.patterns import Pattern as TPattern
from repro_torch.core.patterns import SlideDecomposition as TDec
from repro_torch.core.patterns import TWO_FOUR as TTWO_FOUR
from repro_torch.kernels import fused_slide_matmul as fsm, ref


def _seed(key) -> int:
    return zlib.crc32(repr(key).encode())


def _phi(rng, n, m, groups, recipe):
    """Phi(q(W)) of a pruned Gaussian W, through the port (bit-equal to
    JAX's, tests/test_torch_core.py); w4 values in [-8, 7]."""
    k = 2 * n * groups
    w = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    dec = TDec(TPattern.from_family(n), TTWO_FOUR)
    rec = precision.resolve(recipe)
    q = rec.quantize_weight(packer.prune_to_pattern(w, dec.source)).q
    return slide.phi(q, dec), dec


@pytest.mark.parametrize("recipe", ["int8", "w4"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_meta_and_decompress_slided_match_jax(recipe, n):
    rng = np.random.default_rng(_seed(("meta", recipe, n)))
    ws, tdec = _phi(rng, n, 24, 7, recipe)
    jdec = SlideDecomposition(Pattern.from_family(n), TWO_FOUR)
    packed = recipe == "w4"
    jc = jcomp.compress(jnp.asarray(ws.numpy()), jdec, pack_values=packed)
    tc = tcomp.compress(ws, tdec, pack_values=packed)
    np.testing.assert_array_equal(np.asarray(jc.indices), tc.indices.numpy())
    want = np.asarray(jcomp.decompress_slided(jc))
    got = tcomp.decompress_slided(tc)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ws.numpy())
    words = tcomp.pack_meta(tc.indices)
    np.testing.assert_array_equal(words.numpy(),
                                  np.asarray(jcomp.pack_meta(jc.indices)))
    count = tc.indices.shape[-1]
    np.testing.assert_array_equal(
        tcomp.unpack_meta(words, count).numpy(),
        np.asarray(jcomp.unpack_meta(jnp.asarray(words.numpy()), count)))
    np.testing.assert_array_equal(tcomp.unpack_meta(words, count).numpy(),
                                  tc.indices.numpy())


def _planted(rng, m, gk, lo=-127, hi=128):
    """[m, gk] int8 where window w of row r holds one non-zero at position
    (r + w) % 4 for every third window, two non-zeros at a random pair,
    or none, so every single-non-zero position occurs in every row."""
    w = np.zeros((m, gk // 4, 4), np.int8)
    for r in range(m):
        for j in range(gk // 4):
            kind = (r + j) % 3
            v = rng.integers(lo, hi, 2)
            v[v == 0] = 1
            if kind == 0:
                w[r, j, (r + j // 3) % 4] = v[0]
            elif kind == 1:
                a, b = sorted(rng.choice(4, 2, replace=False))
                w[r, j, a], w[r, j, b] = v
    return torch.from_numpy(w.reshape(m, gk))


def _pairs(meta, ks):
    """Every window's (p0, p1) from the metadata words (padding
    included)."""
    words = meta.permute(0, 1, 3, 2).reshape(meta.shape[0], -1, 32)
    shifts = 4 * torch.arange(8, dtype=torch.int32)
    nib = (words[..., None] >> shifts) & 0xF
    return nib & 3, nib >> 2


def _read_as_mma_sp(values, meta, m, gk, packed):
    """Phi(W) as the m16n8k64 .s8 instruction reads the operand: lane
    L = 4g + t, register j, byte b is kept value c = 4t + b + 16 (j >> 1)
    of row g + 8 (j & 1), window c // 2, slot c % 2; the positions of
    row r, window w sit in lane 4 (r % 8) + (r // 8) + 2 (w // 8), nibble
    w % 8, bits 2 slot (the layouts of the PTX ISA, confirmed on the card).
    'w4': k-step ks is half ks % 2 of the 16 bytes at ks // 2."""
    mt, ks = -(-m // 16), -(-gk // 64)
    v = values.numpy().astype(np.int8)
    if packed:
        lo = (v.astype(np.int16) << 12 >> 12).astype(np.int8)
        hi = (v >> 4).astype(np.int8)
        nib = np.stack([lo, hi], -1).reshape(mt, -1, 32, 2, 16)
        v = nib.transpose(0, 1, 3, 2, 4).reshape(mt, -1, 32, 16)[:, :ks]
    e = meta.numpy().view(np.uint32)                 # [mt, kq, 32, 4]
    dense = np.zeros((mt * 16, ks * 64), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(4):
            row = g + 8 * (j & 1)
            for b in range(4):
                c = 4 * t + b + 16 * (j >> 1)
                w, slot = c // 2, c % 2
                src = 4 * (row % 8) + row // 8 + 2 * (w // 8)
                for k in range(ks):
                    word = e[:, k // 4, src, k % 4].astype(np.int64)
                    p = (word >> (4 * (w % 8) + 2 * slot)) & 3
                    cols = 64 * k + 4 * w + p
                    dense[np.arange(mt) * 16 + row, cols] += v[:, k, lane,
                                                              4 * j + b]
    return dense[:m, :gk]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m,gk", [(37, 96), (16, 64), (40, 5 * 64 + 32)])
def test_sparse_operand_round_trip_and_layout(packed, m, gk):
    rng = np.random.default_rng(_seed(("operand", packed, m, gk)))
    ws = _planted(rng, m, gk, *((-8, 8) if packed else (-127, 128)))
    src = packer.pack_nibbles(ws) if packed else ws
    values, meta = fsm.sparse_operand(src, packed=packed)
    ks = -(-gk // 64)
    assert values.shape == (-(-m // 16), -(-ks // 2) if packed else ks, 32,
                            16)
    assert meta.shape == (-(-m // 16), -(-ks // 4), 32, 4)
    back = fsm.dense_from_operand(values, meta, m, gk, packed=packed)
    assert torch.equal(back, src)
    p0, p1 = _pairs(meta, ks)
    assert bool((p0 < p1).all())
    np.testing.assert_array_equal(
        _read_as_mma_sp(values, meta, m, gk, packed), ws.numpy())


def test_sparse_operand_canonicalises_jax_slot_order():
    """A window whose lone non-zero sits at p > 0 gets JAX's pair (p, 0);
    the operand swaps it to (0, p), which moves only the zero."""
    ws = torch.zeros((16, 64), dtype=torch.int8)
    for p in range(4):
        ws[p, 4 * p + p] = 5 + p
    dec = TDec(TPattern(2, 4), TTWO_FOUR)
    idx = tcomp.compress(ws, dec).indices.reshape(16, 16, 2)
    assert [tuple(idx[p, p].tolist()) for p in range(4)] == [
        (0, 1), (1, 0), (2, 0), (3, 0)]
    values, meta = fsm.sparse_operand(ws)
    p0, p1 = _pairs(meta, 1)
    assert bool((p0 < p1).all())
    assert torch.equal(fsm.dense_from_operand(values, meta, 16, 64), ws)
    with pytest.raises(ValueError, match="more than 2"):
        fsm.sparse_operand(torch.ones((16, 64), dtype=torch.int8))


@pytest.mark.parametrize("recipe", ["int8", "w4", "fp8", "fp8w4"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_plain_on_operand_matches_pallas(recipe, n):
    rng = np.random.default_rng(_seed(("plain", recipe, n)))
    m, k = 40, 2 * n * 6
    w = rng.standard_normal((m, k)).astype(np.float32) * k ** -0.5
    x = rng.standard_normal((5, k)).astype(np.float32)
    x *= np.exp(rng.uniform(-4, 4, size=(5, 1))).astype(np.float32)
    bias = rng.standard_normal((m,)).astype(np.float32)
    jcfg = jlin.SparsityConfig(pattern=(2 * n - 2, 2 * n), mode="slided",
                               recipe=recipe, use_pallas=False)
    tcfg = tlin.SparsityConfig(pattern=(2 * n - 2, 2 * n), mode="slided",
                               recipe=recipe)
    jp = jlin.prepare({"w": jnp.asarray(w)}, jcfg)
    tp = tlin.prepare({"w": torch.from_numpy(w)}, tcfg)
    rec, dec = tcfg.recipe, tcfg.decomposition()
    got = ref.slided_matmul_sparse(
        torch.from_numpy(x), tp["sp_values"], tp["sp_meta"], tp["s_w"], dec,
        rec, torch.float32, bias=torch.from_numpy(bias)).numpy()
    want = np.asarray(jfsm.fused_slided_matmul_pallas(
        jnp.asarray(x), jp["w_slided"], jp["s_w"], jnp.asarray(bias),
        n_fam=n, out_dtype=jnp.float32, interpret=True, act=rec.act,
        w4=rec.packed_weights))
    if rec.act == "int8":
        oracle = np.asarray(jref.slided_matmul_quant(
            jnp.asarray(x), jp["w_slided"], jp["s_w"], jcfg.decomposition(),
            recipe, jnp.float32, bias=jnp.asarray(bias)))
        np.testing.assert_array_equal(got, oracle)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        tol = 1e-5 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)
