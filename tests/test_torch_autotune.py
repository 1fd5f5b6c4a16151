"""The port's split-count autotuner (``repro_torch.kernels.autotune``):
each case of the JAX package's ``tests/test_autotune.py``, with a CUDA
graph capture (monkeypatched) in place of JAX's tracing, and the wiring
into ``kernels.ops``: with the one seam between kernel and plain version
(``ops._on_card``) set and a CUDA wrapper swapped for a recording
stand-in, the knob the wrapper receives is what ``tiles_for`` gives.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat

from repro_torch.core import linear as tlin
from repro_torch.core.compressed import CompressedSlided
from repro_torch.kernels import autotune, ops, ref, roofline
from repro_torch.kernels import fused_slide_matmul as fsm
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import slide_matmul as smm


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_PEAK_BW_GBPS", "10.0")
    monkeypatch.setenv("REPRO_PEAK_GFLOPS", "100.0")
    roofline.peaks(refresh=True)
    autotune.clear()
    yield
    autotune.clear()
    roofline._PEAKS.clear()


def test_tileconfig_kernel_kwargs_filters_none_and_names():
    t = autotune.TileConfig(bm=128, br=None, bk=256, block_rows=64)
    assert t.kernel_kwargs() == {"bm": 128, "bk": 256, "block_rows": 64}
    assert t.kernel_kwargs("bm", "br") == {"bm": 128}
    assert autotune.TileConfig(splits=3).kernel_kwargs() == {"splits": 3}


def test_rows_bucket_equals_jax():
    for rows in list(range(0, 300)) + [333, 1000, 4096, 4097, 70000]:
        assert autotune.rows_bucket(rows) == jat.rows_bucket(rows)
    assert autotune.rows_bucket(1) == 8
    assert autotune.rows_bucket(9) == 16
    assert autotune.rows_bucket(333) == 512


def test_lookup_miss_returns_default_tiles():
    assert autotune.tiles_for("op", rows=8, m=8, k=8) == autotune.DEFAULT


def test_key_carries_backend_and_shards():
    key = autotune.make_key("op", rows=8, m=16, k=32, adt="int8")
    assert key == "op|adt=int8|k=32|m=16|rows=8|backend=cpu|shards=1"


def test_record_and_lookup_roundtrip_in_process():
    key = autotune.make_key("op", rows=8, m=16, k=32)
    autotune.record(key, autotune.TileConfig(bm=128, br=64), 12.5)
    assert autotune.lookup(key) == autotune.TileConfig(bm=128, br=64)


def test_disk_cache_survives_process_state_reset():
    key = autotune.make_key("op", rows=8, m=16, k=32)
    autotune.record(key, autotune.TileConfig(splits=4), 3.0)
    with open(autotune.cache_path()) as f:
        disk = json.load(f)
    assert disk[key]["tiles"]["splits"] == 4
    assert disk[key]["backend"] == "cpu"
    autotune.clear()
    autotune._DISK_LOADED = False
    assert autotune.lookup(key) == autotune.TileConfig(splits=4)


def test_default_cache_file_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    path = autotune.cache_path()
    assert path.endswith(os.path.join(".cache", "repro_torch",
                                      "autotune.json"))
    assert path != jat.cache_path()


@pytest.mark.parametrize("payload", [
    '{"half": {"tiles": {"bm": 64',       # truncated (interrupted writer)
    "[1, 2, 3]",                          # parses, but root is not a dict
    '{"key": 5}',                         # record is not an object
    "\x00\xff garbage",                   # not JSON at all
])
def test_corrupt_disk_cache_quarantined_not_fatal(payload):
    path = autotune.cache_path()
    with open(path, "w") as f:
        f.write(payload)
    autotune.clear()
    autotune._DISK_LOADED = False
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert autotune.lookup("whatever") is None
    assert not os.path.exists(path)
    with open(path + ".bak") as f:
        assert f.read() == payload
    key = autotune.make_key("op", rows=8, m=16, k=32)
    autotune.record(key, autotune.TileConfig(bm=128), 1.0)
    autotune.clear()
    autotune._DISK_LOADED = False
    assert autotune.lookup(key) == autotune.TileConfig(bm=128)


def test_cache_disabled_with_empty_env(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "")
    assert autotune.cache_path() is None
    autotune.record(autotune.make_key("op", rows=1, m=1, k=1),
                    autotune.DEFAULT, 1.0)


def test_merge_on_write_keeps_a_concurrent_writers_keys():
    """Two processes' tunings survive in one file: a key written by
    another process after this one loaded the file is kept when this one
    records its own."""
    mine = autotune.make_key("op", rows=8, m=1, k=1)
    theirs = autotune.make_key("op", rows=16, m=1, k=1)
    autotune.lookup(mine)  # loads the (absent) file
    with open(autotune.cache_path(), "w") as f:
        json.dump({theirs: {"tiles": {"splits": 2}, "us": 1.0}}, f)
    autotune.record(mine, autotune.TileConfig(splits=3), 2.0)
    with open(autotune.cache_path()) as f:
        disk = json.load(f)
    assert disk[theirs]["tiles"]["splits"] == 2
    assert disk[mine]["tiles"]["splits"] == 3


def test_autotune_picks_fastest_candidate():
    slow = autotune.TileConfig(splits=1)
    fast = autotune.TileConfig(splits=2)

    def run(tiles):
        if tiles == slow:
            time.sleep(0.01)
        return np.zeros(())

    key = autotune.make_key("op", rows=1, m=1, k=1)
    assert autotune.autotune("op", run, [slow, fast], key=key) == fast
    assert autotune.lookup(key) == fast


def test_autotune_skips_crashing_candidates():
    bad = autotune.TileConfig(splits=7)

    def run(tiles):
        if tiles == bad:
            raise ValueError("invalid split")
        return np.zeros(())

    assert autotune.autotune("op", run, [bad, autotune.DEFAULT]) \
        == autotune.DEFAULT


def test_autotune_raises_a_failed_launch_and_frees_the_flush():
    """A candidate whose build or launch fails (RuntimeError) is not taken
    for an invalid shape: the search raises.  The L2 flush buffer does not
    outlive a search."""
    def run(tiles):
        if tiles.splits == 2:
            raise RuntimeError("CUDA launch failed")
        return np.zeros(())

    with pytest.raises(RuntimeError, match="launch failed"):
        autotune.autotune("op", run, [autotune.DEFAULT,
                                      autotune.TileConfig(splits=2)])
    autotune._FLUSH.append(object())
    autotune.autotune("op", lambda t: None, [autotune.DEFAULT])
    assert autotune._FLUSH == []


def test_autotune_prunes_bandwidth_hopeless_splits():
    """A split count whose int32 partials make its modeled traffic more
    than PRUNE_RATIO x the least is never timed; the entry records the
    bound, the efficiency and why."""
    params = dict(pattern="6:8", adt="int8", wdt="int8", odt="bfloat16")
    rows, m, k = 128, 3840, 3840
    cands = [autotune.TileConfig(splits=s) for s in (1, 2, 32)]
    tr = [roofline.tile_traffic("compressed_matmul", rows, m, k, None, None,
                                splits=t.splits, **params) for t in cands]
    assert tr[2] > autotune.PRUNE_RATIO * tr[0] > tr[1]
    timed = []
    key = autotune.make_key("compressed_matmul", rows=rows, m=m, k=k,
                            **params)
    autotune.autotune("compressed_matmul",
                      lambda t: timed.append(t.splits), cands, key=key,
                      rows=rows, m=m, k=k, params=params)
    assert 32 not in timed and {1, 2} <= set(timed)
    entry = autotune._MEM[key]
    assert "1 roofline-pruned" in entry["why"]
    assert entry["roofline_us"] > 0 and entry["efficiency"] > 0


def test_candidates_are_the_kernels_knobs():
    """B4/B5 (no run-time knob) and B1's decode instance: [DEFAULT]; B1's
    prefill and B3: split counts that leave no split empty (B3's decode
    splits lifting at most DEC_MAX_STAGES stages each); B2: page-range
    splits; all sized by the rows bucket."""
    p = dict(pattern="6:8", adt="int8", wdt="int8")
    assert autotune.candidates("fused_quant_slide", 4, 0, 3840, **p) \
        == [autotune.DEFAULT]
    assert autotune.candidates("quant_matmul", 128, 3840, 3840,
                               adt="int8", wdt="int8") == [autotune.DEFAULT]
    assert autotune.candidates("compressed_matmul", 4, 3840, 3840, **p) \
        == [autotune.DEFAULT]
    # rows 9 buckets to 16, still B1's decode instance
    assert autotune.candidates("compressed_matmul", 9, 3840, 3840, **p) \
        == [autotune.DEFAULT]
    for op, rows in (("compressed_matmul", 128), ("fused_slided_matmul", 4),
                     ("fused_slided_matmul", 128)):
        cands = autotune.candidates(op, rows, 3840, 3840, **p)
        assert cands[0] == autotune.DEFAULT and len(cands) > 2
        if op == "compressed_matmul":
            stages = -(-3840 // smm.prefill_stage(4))
        else:
            stages = -(-(-(-roofline.lifted_k(3840, 4) // fsm.KSTEP))
                       // fsm.STAGE_KS)
        for t in cands[1:]:
            s = t.splits
            assert -(-stages // -(-stages // s)) == s  # none empty
            if op == "fused_slided_matmul" and rows <= fsm.DECODE_MAX_R:
                assert -(-stages // s) <= fsm.DEC_MAX_STAGES
    assert autotune.candidates("fused_slided_matmul", 4, 3840, 3840,
                               pattern="6:8", adt="fp8", wdt="int8") \
        == [autotune.DEFAULT]
    b2 = autotune.candidates("paged_attention", 4, 960, 1024, adt="bfloat16")
    assert b2[0] == autotune.DEFAULT
    assert [t.br for t in b2[1:]] == [1, 2, 3, 4, 6, 8, 12, 16]
    assert autotune.split_options(5) == [1, 2, 3, 5]


def _capturing(monkeypatch):
    autotune.backend()  # the key's backend, computed before the patch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)


def test_tune_skipped_during_capture(monkeypatch):
    """A CUDA graph capture records launches and runs none: tuning inside
    one would time nothing and cache noise.  It is skipped (the timer's
    count does not move); a cached entry still applies there."""
    calls = []
    _capturing(monkeypatch)
    assert autotune.tracing()
    before = autotune._COUNTS["timed"]
    got = autotune.tiles_for("compressed_matmul", rows=128, m=64, k=64,
                             tune=True, run=lambda t: calls.append(t),
                             pattern="6:8", adt="int8")
    assert got == autotune.DEFAULT and not calls
    assert autotune._COUNTS["timed"] == before
    key = autotune.make_key("compressed_matmul", rows=128, m=64, k=64,
                            adt="int8", pattern="6:8")
    assert autotune.lookup(key) is None
    autotune.record(key, autotune.TileConfig(splits=2), 1.0)
    assert autotune.tiles_for("compressed_matmul", rows=100, m=64, k=64,
                              tune=True, run=lambda t: calls.append(t),
                              pattern="6:8", adt="int8") \
        == autotune.TileConfig(splits=2)
    assert not calls


def test_tune_skipped_on_fake_and_meta_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode
    assert autotune.tracing(torch.empty(2, device="meta"))
    with FakeTensorMode():
        assert autotune.tracing(torch.empty(2))
    assert not autotune.tracing(torch.empty(2))


# ------------------------------------------------- the wiring into ops
def _slided_weights(m=16, k=32):
    cfg = tlin.SparsityConfig(pattern=(6, 8), mode="slided", recipe="int8")
    gen = torch.Generator().manual_seed(0)
    return cfg, tlin.prepare(tlin.init(gen, k, m), cfg)


def _stand_in(monkeypatch, module, name, plain):
    """Swap the CUDA wrapper ``module.name`` for one that records its
    keyword arguments and returns ``plain(...)``; route CPU tensors to it."""
    got = []

    def fake(*args, **kwargs):
        got.append(kwargs)
        return plain(*args, **kwargs)
    monkeypatch.setattr(module, name, fake)
    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    return got


def test_ops_tune_records_and_reuses(monkeypatch):
    """B3 through ops with tune=True: the search times the stand-in with
    each candidate split (leaving the launch counters as they were),
    records the winner under JAX's key params, and a second call hits
    the cache; outputs equal the plain version's."""
    cfg, p = _slided_weights()
    dec = cfg.decomposition()
    x = torch.randn(8, 32, generator=torch.Generator().manual_seed(1))

    def plain(x2, values, meta, s_w, bias, **kw):
        return ref.slided_matmul_sparse(x2, values, meta, s_w, dec,
                                        cfg.recipe, kw["out_dtype"])
    got = _stand_in(monkeypatch, fsm, "fused_slided_matmul_cuda", plain)
    counts = ops.launch_counts()
    y = ops.slided_matmul_quant(x, p["sp_values"], p["sp_meta"], p["s_w"],
                                dec, recipe="int8", tune=True)
    assert ops.launch_counts() == counts  # the stand-in counts nothing
    assert {kw["splits"] for kw in got[:-1]} >= {None, 1}
    key = autotune.make_key("fused_slided_matmul", rows=8, m=16, k=32,
                            pattern="6:8", xdt="float32", adt="int8",
                            wdt="int8", odt="float32", wfmt="2:4")
    entry = autotune.lookup(key)
    assert entry is not None and got[-1]["splits"] == entry.splits
    calls = []
    monkeypatch.setattr(autotune, "autotune",
                        lambda *a, **kw: calls.append(1) or autotune.DEFAULT)
    y2 = ops.slided_matmul_quant(x, p["sp_values"], p["sp_meta"], p["s_w"],
                                 dec, recipe="int8", tune=True)
    assert not calls
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(y, plain(x, p["sp_values"], p["sp_meta"],
                                        p["s_w"], None,
                                        out_dtype=torch.float32),
                               rtol=0, atol=0)


def test_cached_split_feeds_b1_and_none_without_cache(monkeypatch):
    """Without a cache entry B1's wrapper gets splits=None (its heuristic,
    the main path's launch of before); with one, the cached split."""
    cfg = tlin.SparsityConfig(pattern=(6, 8), mode="compressed",
                              recipe="int8")
    gen = torch.Generator().manual_seed(0)
    p = tlin.prepare(tlin.init(gen, 48, 24), cfg)
    c = CompressedSlided(p["values"], p["indices"], 48, 6, 8, 2, 4)
    x = torch.randn(40, 48, generator=gen)
    got = _stand_in(monkeypatch, smm, "compressed_matmul_cuda",
                    lambda *a, **kw: torch.zeros((40, 24)))
    ops.compressed_matmul(x, c, s_w=p["s_w"], recipe="int8")
    assert got[-1]["splits"] is None
    key = autotune.make_key("compressed_matmul", rows=64, m=24, k=48,
                            pattern="6:8", adt="int8", wdt="int8",
                            odt="float32")
    autotune.record(key, autotune.TileConfig(splits=3), 5.0)
    ops.compressed_matmul(x, c, s_w=p["s_w"], recipe="int8")
    assert got[-1]["splits"] == 3


def test_b2_decode_and_verify_share_one_split(monkeypatch):
    """B2's key holds lanes=1 for every row-exact call: a verify step
    (L = 4) takes the decode step's cached split, so its rows keep the
    decode calls' merge order; the prefill chunk (row_exact=False) keys
    on its lanes."""
    b, kvh, hd, h, page, maxp = 2, 2, 8, 4, 4, 6
    gen = torch.Generator().manual_seed(0)
    pool = {"k": torch.randn(13, page, kvh, hd, generator=gen),
            "v": torch.randn(13, page, kvh, hd, generator=gen)}
    table = torch.randint(0, 12, (b, maxp), generator=gen, dtype=torch.int32)
    kv_len = torch.tensor([9, 17], dtype=torch.int32)
    got = _stand_in(monkeypatch, pa, "paged_attention_cuda",
                    lambda q, *a, **kw: torch.zeros_like(q))
    params = dict(adt="float32", xdt="float32", kvh=kvh, hd=hd, qh=h,
                  window=0)
    autotune.record(autotune.make_key(
        "paged_attention", rows=8, m=kvh * hd, k=maxp * page, lanes=1,
        **params), autotune.TileConfig(br=2), 1.0)
    for lanes in (1, 4):
        q = torch.randn(b, lanes, h, hd, generator=gen)
        ops.paged_attention(q, pool, table, kv_len)
        assert got[-1]["splits"] == 2
    ops.paged_attention(torch.randn(b, 4, h, hd, generator=gen), pool,
                        table, kv_len, row_exact=False)
    assert got[-1]["splits"] is None


def test_b2_tuned_bound_prices_the_tokens_read(monkeypatch):
    """A tuned B2 entry's bound is ``op_cost`` at the mean tokens the
    timed call reads (kv_len + lanes - 1 a sequence), not at the table's
    capacity, which the key carries."""
    b, kvh, hd, h, page, maxp = 3, 2, 8, 4, 4, 8
    gen = torch.Generator().manual_seed(0)
    pool = {"k": torch.randn(25, page, kvh, hd, generator=gen),
            "v": torch.randn(25, page, kvh, hd, generator=gen)}
    table = torch.randint(0, 24, (b, maxp), generator=gen, dtype=torch.int32)
    kv_len = torch.tensor([5, 17, 9], dtype=torch.int32)
    _stand_in(monkeypatch, pa, "paged_attention_cuda",
              lambda q, *a, **kw: torch.zeros_like(q))
    ops.paged_attention(torch.randn(b, 1, h, hd, generator=gen), pool,
                        table, kv_len, tune=True)
    params = dict(adt="float32", xdt="float32", kvh=kvh, hd=hd, qh=h,
                  window=0, lanes=1)
    (entry,) = autotune._MEM.values()
    assert next(iter(autotune._MEM)) == autotune.make_key(
        "paged_attention", rows=8, m=kvh * hd, k=maxp * page, **params)
    p = roofline.peaks("float32")
    read = roofline.op_cost("paged_attention", b, kvh * hd, 31 / 3, **params)
    cap = roofline.op_cost("paged_attention", b, kvh * hd, maxp * page,
                           **params)
    assert entry["roofline_us"] == roofline.roofline_us(read, p)
    assert entry["roofline_us"] < roofline.roofline_us(cap, p)


def test_b4_b5_launch_without_the_tuner(monkeypatch):
    """B4 and B5 take no run-time knob: on the card their wrappers
    launch without consulting the autotuner."""
    from repro_torch.core.patterns import SlideDecomposition
    from repro_torch.kernels import fused_quant_slide as fqs
    from repro_torch.kernels import quant_matmul as qmm
    monkeypatch.setattr(autotune, "tiles_for", lambda *a, **kw: pytest.fail(
        "tiles_for reached by a kernel without a knob"))
    dec = tlin.SparsityConfig(pattern=(6, 8)).decomposition()
    assert isinstance(dec, SlideDecomposition)
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(2))
    got = _stand_in(monkeypatch, fqs, "fused_quant_slide_cuda",
                    lambda x2, **kw: ref.fused_quant_slide(x2, dec))
    q, s = ops.fused_quant_slide(x, dec)
    assert got == [{"n_fam": 4, "fp8": False}]
    got = _stand_in(monkeypatch, qmm, "quant_matmul_cuda",
                    lambda *a, **kw: torch.zeros((4, 16)))
    w = torch.randint(-127, 128, (16, q.shape[-1]), dtype=torch.int8)
    ops.quant_matmul(q, s, w, torch.ones(16, 1))
    assert len(got) == 1


def test_cpu_tensors_never_reach_the_tuner(monkeypatch):
    """A CPU tensor takes the plain version, as JAX's reference path
    skips the autotuner."""
    monkeypatch.setattr(autotune, "tiles_for", lambda *a, **kw: pytest.fail(
        "tiles_for on a CPU tensor"))
    cfg, p = _slided_weights()
    x = torch.randn(8, 32)
    ops.slided_matmul_quant(x, p["sp_values"], p["sp_meta"], p["s_w"],
                            cfg.decomposition(), recipe="int8", tune=True)


def test_sparsity_config_tune_reaches_the_kernel(monkeypatch):
    """``SparsityConfig.tune`` (default False, as JAX's) passes through
    ``linear.apply`` to the kernel's dispatch."""
    assert tlin.SparsityConfig().tune is False
    seen = []
    real = ops.slided_matmul_quant
    monkeypatch.setattr(ops, "slided_matmul_quant", lambda *a, **kw: (
        seen.append(kw["tune"]), real(*a, **kw))[1])
    for tune in (False, True):
        cfg = tlin.SparsityConfig(pattern=(6, 8), mode="slided",
                                  recipe="int8", tune=tune)
        _, p = _slided_weights()
        tlin.apply(p, torch.randn(3, 32), cfg)
    assert seen == [False, True]
