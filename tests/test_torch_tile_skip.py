"""``AttnSpec.tile_skip``: a sliding-window layer's one-shot attention
visits only the KV chunks its window reaches, held against JAX's skip and
against the port's own full scan.

* At ``q_offset = 0`` the port's skip equals JAX's at JAX's three cases
  (``tests/test_attention_variants.py``), fp32 at JAX's 1e-5.
* The port's skip equals its full scan bit for bit, at integer and
  int32-device-scalar offsets (a paged prefill chunk's), gradients
  included: a skipped chunk is wholly masked, and a wholly masked chunk
  adds exactly zero once a valid chunk rescales the running sums.
* JAX's slice starts from ``qi * cq`` without ``q_offset``: at an offset
  its skip departs from its own full scan, where the port's does not.
* The skip's counted FLOPs (``launch.op_cost``) fall below half.
* A smoke h2o-danube loss (and its gradients) with ``swa_tile_skip``
  equals the loss without it.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn

from repro_torch.configs import registry as treg
from repro_torch.launch import op_cost
from repro_torch.models import attention as tattn, model as TM, transformer
from repro_torch.runtime import steps


def _specs(mod, **kw):
    base = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                causal=True, sliding_window=None, q_chunk=16, kv_chunk=16,
                tile_skip=False)
    base.update(kw)
    off = mod.AttnSpec(**base)
    return off, dataclasses.replace(off, tile_skip=True)


def _qkv(seed, sq, sk, b=2, h=4, kvh=2, hd=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, hd)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, hd)).astype(np.float32))


@pytest.mark.parametrize("window,s,cq", [(8, 64, 16), (16, 128, 16),
                                         (24, 96, 32)])
def test_tile_skip_matches_jax_at_offset_zero(window, s, cq):
    arrays = _qkv(1, s, s)
    _, jspec = _specs(jattn, sliding_window=window, q_chunk=cq, kv_chunk=cq)
    _, tspec = _specs(tattn, sliding_window=window, q_chunk=cq, kv_chunk=cq)
    want = np.asarray(jattn._chunked_sdpa(jspec, *map(jnp.asarray, arrays)))
    got = tattn._chunked_sdpa(tspec, *map(torch.from_numpy, arrays))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _run(spec, arrays, q_offset, grad_seed=5):
    """Output and the gradients of q, k, v under a seeded cotangent."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    out = tattn._chunked_sdpa(spec, q, k, v, q_offset=q_offset)
    g = torch.from_numpy(np.random.default_rng(grad_seed).standard_normal(
        out.shape).astype(np.float32))
    (out * g).sum().backward()
    return out.detach(), q.grad, k.grad, v.grad


# window 16 over chunks of 16: Sq = 32 queries at the end of Sk = 256 keys
# (224: chunk-aligned, the offset of the reference check), unaligned (203,
# 17), and 0
@pytest.mark.parametrize("kind", ["int", "device"])
@pytest.mark.parametrize("offset", [0, 17, 203, 224])
def test_tile_skip_is_the_full_scan_bit_for_bit(kind, offset):
    arrays = _qkv(2, 32, 256)
    off, on = _specs(tattn, sliding_window=16)
    q_offset = (offset if kind == "int"
                else torch.tensor(offset, dtype=torch.int32))
    for a, b in zip(_run(off, arrays, q_offset), _run(on, arrays, q_offset)):
        assert torch.equal(a, b)


def test_tile_skip_visits_only_the_window(monkeypatch):
    """The chunk pairs visited (one ``_mask_tile`` each): all nq x nk
    without the skip, ``n_win`` a query chunk with it; the window at a
    device offset is the integer offset's, clamped into the nk chunks."""
    off, on = _specs(tattn, sliding_window=16)
    assert tattn._kv_window(off, 200, 0, 16, 16, 16) == (0, 16)
    assert tattn._kv_window(on, 200, 0, 16, 16, 16) == (11, 3)  # keys 185..
    dev, n = tattn._kv_window(on, torch.tensor(200, dtype=torch.int32),
                              0, 16, 16, 16)
    assert (int(dev), n) == (11, 3)
    assert tattn._kv_window(on, 0, 0, 16, 16, 16) == (0, 3)
    assert tattn._kv_window(on, 224, 1, 16, 16, 16) == (13, 3)
    pairs = []
    sound = tattn._mask_tile
    monkeypatch.setattr(tattn, "_mask_tile",
                        lambda *a: pairs.append(1) or sound(*a))
    x = tuple(map(torch.from_numpy, _qkv(2, 32, 256)))
    for spec, want in ((off, 2 * 16), (on, 2 * 3)):
        pairs.clear()
        tattn._chunked_sdpa(spec, *x, q_offset=224)
        assert len(pairs) == want


def test_jax_offset_fault_beside_the_port():
    """JAX's skip drops ``q_offset`` from its first chunk: at offset 224
    (window 16, chunks 16, Sk 256, Sq 32) it departs from its own full
    scan by O(1) (1.56 on the reference check), at offset 0 it is
    bit-equal to it; the port's skip equals JAX's full scan at both."""
    arrays = _qkv(2, 32, 256)
    joff, jon = _specs(jattn, sliding_window=16)
    toff, ton = _specs(tattn, sliding_window=16)
    jx = tuple(map(jnp.asarray, arrays))
    tx = tuple(map(torch.from_numpy, arrays))
    for offset in (0, 224):
        full = np.asarray(jattn._chunked_sdpa(joff, *jx, q_offset=offset))
        jskip = np.asarray(jattn._chunked_sdpa(jon, *jx, q_offset=offset))
        tskip = tattn._chunked_sdpa(ton, *tx, q_offset=offset).numpy()
        jax_gap = float(np.abs(jskip - full).max())
        if offset:
            assert jax_gap > 0.5, jax_gap
        else:
            assert jax_gap == 0.0, jax_gap
        np.testing.assert_allclose(tskip, full, rtol=1e-5, atol=1e-5)
        assert np.array_equal(
            tskip, tattn._chunked_sdpa(toff, *tx, q_offset=offset).numpy())


def test_tile_skip_cuts_flops():
    arrays = tuple(map(torch.from_numpy, _qkv(2, 512, 512, b=1)))
    off, on = _specs(tattn, sliding_window=32, q_chunk=64, kv_chunk=64)
    f0 = op_cost.of_function(tattn._chunked_sdpa, off, *arrays)["flops"]
    f1 = op_cost.of_function(tattn._chunked_sdpa, on, *arrays)["flops"]
    assert f1 < 0.5 * f0, (f0, f1)


def test_smoke_danube_loss_with_tile_skip(monkeypatch):
    """cfg.swa_tile_skip reaches the spec, and the smoke loss and its
    gradients are the full scan's bit for bit (the spec's chunks cut to
    16, so that S = 128 spans 8 of them and a window of 16 skips)."""
    sound = transformer.attn_spec
    seen = []

    def spec(cfg, kind):
        s = dataclasses.replace(sound(cfg, kind), q_chunk=16, kv_chunk=16)
        seen.append(s.tile_skip)
        return s

    monkeypatch.setattr(transformer, "attn_spec", spec)
    base = treg.smoke_config("h2o-danube-3-4b")
    params = TM.init(base, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, base.vocab_size, (2, 128)))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    results = []
    for skip in (False, True):
        seen.clear()
        results.append(steps._grads(
            dataclasses.replace(base, swa_tile_skip=skip), params,
            steps.trainable(params), batch))
        assert seen and set(seen) == {skip}
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
