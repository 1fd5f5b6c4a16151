"""The port's serving engine held against the JAX engine.

* Token streams: the port's ``ServeEngine`` on the CPU (fused paged
  attention's plain version, every linear through the compressed or the
  slided plain version) and the JAX ``ServeEngine`` (``fused_attention=
  True``, its jnp flash mirror) serve the same weights and the same
  traffic — staggered arrivals plus one request that joins mid-flight —
  and must emit IDENTICAL greedy streams for both modes and the ``none``,
  ``int8``, ``fp8`` and ``w4`` recipes, and for int8 with int8 KV pages.
* Slided int8 == compressed int8 in the port, streams and first-token
  logits bit for bit (the gate chip_smoke holds on the card); the slided
  weights, stored as the fused kernel's 2:4 operand, invert to JAX's
  ``w_slided``.
* The sync-free pool scatter: dropped rows land in the spare page, the
  real pages bit-equal to JAX's ``mode="drop"`` writes and to the masked
  form it replaced; no page table names the spare page.
* The model entry points that allocate run on CUDA unless given a device.
* Scheduler: the port's verbatim copy makes the same decisions as
  ``repro.runtime.scheduler`` on the same submits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import linear as jlin
from repro.models import attention as jattn, model as JM
from repro.runtime import kv_cache as jkv, scheduler as jsch
from repro.runtime import serve_loop as jserve

from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import linear as tlin
from repro_torch.kernels import fused_slide_matmul as tfsm
from repro_torch.models import attention as tattn, layers as tlayers
from repro_torch.models import model as TM, transformer as ttf
from repro_torch.runtime import faults as tfl, kv_cache as tkv
from repro_torch.runtime import scheduler as tsch
from repro_torch.runtime import serve_loop as tserve

ARCH = "h2o-danube-3-4b"
ECFG = dict(max_batch=2, page_size=4, num_pages=24, max_seq_len=40,
            prefill_chunk=8)
NEW_TOKENS = 6
JOIN_STEP, JOIN_RID = 5, 9  # a request submitted mid-flight


def _traffic():
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, size=int(n)).tolist() for n in (5, 11, 7)]
    late = rng.integers(0, 128, size=9).tolist()
    return prompts, late


def _serve(eng, prompts, late):
    for i, p in enumerate(prompts):
        eng.submit(p, NEW_TOKENS, rid=i, arrival=2 * i)  # staggered joins

    def on_step(e, k):
        if k == JOIN_STEP:
            e.submit(late, NEW_TOKENS, rid=JOIN_RID, arrival=k)

    out = eng.run(on_step=on_step)
    eng.kv.check()
    return {rid: c.tokens for rid, c in out.items()}


@pytest.fixture(scope="module")
def jax_tree():
    cfg = jreg.smoke_config(ARCH)
    return jax.tree_util.tree_map(np.asarray,
                                  JM.init(cfg, jax.random.PRNGKey(0)))


def _tcfg(mode, recipe):
    return dataclasses.replace(treg.smoke_config(ARCH),
                               sparsity=tlin.SparsityConfig(
                                   pattern=(6, 8), mode=mode, recipe=recipe,
                                   fused_attention=True))


@pytest.mark.parametrize("recipe,kv", [
    ("none", "bfloat16"), ("int8", "bfloat16"), ("fp8", "bfloat16"),
    ("w4", "bfloat16"), ("int8", "int8")],
    ids=["none", "int8", "fp8", "w4", "int8-kvint8"])
@pytest.mark.parametrize("mode", ["compressed", "slided"])
def test_engine_streams_match_jax_engine(jax_tree, mode, recipe, kv):
    prompts, late = _traffic()
    jcfg = dataclasses.replace(jreg.smoke_config(ARCH), kv_cache_dtype=kv,
                               sparsity=jlin.SparsityConfig(
                                   pattern=(6, 8), mode=mode,
                                   recipe=recipe, use_pallas=False,
                                   fused_attention=True))
    tcfg = dataclasses.replace(_tcfg(mode, recipe), kv_cache_dtype=kv)
    jeng = jserve.ServeEngine(jserve.pack_params(jax_tree, jcfg), jcfg,
                              jserve.EngineConfig(**ECFG))
    want = _serve(jeng, prompts, late)
    teng = tserve.ServeEngine(
        tserve.pack_params(params_from_jax(jax_tree, tcfg, device="cpu"),
                            tcfg), tcfg,
        tserve.EngineConfig(**ECFG), device="cpu")
    teng.warmup()  # writes nothing: the streams below are unaffected
    got = _serve(teng, prompts, late)
    assert set(got) == {0, 1, 2, JOIN_RID}
    assert all(len(t) == NEW_TOKENS for t in got.values())
    assert got == want
    assert teng.stats.decode_tokens == jeng.stats.decode_tokens
    assert teng.stats.precision == recipe


def test_slided_engine_equals_compressed_engine(jax_tree):
    prompts, late = _traffic()
    engines = {}
    for mode in ("compressed", "slided"):
        cfg = _tcfg(mode, "int8")
        params = tserve.pack_params(
            params_from_jax(jax_tree, cfg, device="cpu"), cfg)
        leaf = params["units"][0]["layer_0"]["ffn"]["w_down"]
        assert set(leaf) == ({"sp_values", "sp_meta", "s_w"}
                             if mode == "slided"
                             else {"values", "indices", "s_w"})
        if mode == "slided":
            # the 2:4 operand, inverted, is JAX's slided matrix
            jcfg = dataclasses.replace(jreg.smoke_config(ARCH),
                                       sparsity=jlin.SparsityConfig(
                                           pattern=(6, 8), mode=mode,
                                           recipe="int8", use_pallas=False))
            jleaf = jserve.pack_params(jax_tree, jcfg)["units"]["layer_0"][
                "ffn"]["w_down"]
            want = np.asarray(jleaf["w_slided"])[0]
            got = tfsm.dense_from_operand(
                leaf["sp_values"], leaf["sp_meta"], leaf["s_w"].shape[0],
                want.shape[-1])
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(leaf["s_w"].numpy(),
                                          np.asarray(jleaf["s_w"])[0])
        engines[mode] = tserve.ServeEngine(params, cfg,
                                           tserve.EngineConfig(**ECFG),
                                           device="cpu")
    streams = {m: _serve(e, prompts, late) for m, e in engines.items()}
    assert streams["slided"] == streams["compressed"]
    first = {m: e.first_logits for m, e in engines.items()}
    assert set(first["slided"]) == set(first["compressed"]) == set(
        streams["slided"])
    for rid, logits in first["compressed"].items():
        assert torch.equal(first["slided"][rid], logits)


def _masked_scatter(pool, page_ids, slot_ids, k_new, v_new):
    """The scatter the sync-free form replaced: dropped rows masked out
    by boolean indexing (a host synchronization on CUDA)."""
    keep = page_ids < tattn.drop_page(pool)
    pid, sid = page_ids[keep].long(), slot_ids[keep].long()
    k_new, v_new = k_new[keep], v_new[keep]
    if pool["k"].dtype == torch.int8:
        k_new, ks = tattn._quant_kv(k_new)
        v_new, vs = tattn._quant_kv(v_new)
        pool["k_scale"][pid, sid] = ks
        pool["v_scale"][pid, sid] = vs
    pool["k"][pid, sid] = k_new.to(pool["k"].dtype)
    pool["v"][pid, sid] = v_new.to(pool["v"].dtype)


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_pool_scatter_drops_like_jax(kind):
    num_pages, ps, kvh, hd, rows = 6, 4, 2, 8, 12
    rng = np.random.default_rng(5)
    # distinct real (page, slot) targets, then dropped rows (page id
    # num_pages), one aimed at a slot a real row also writes
    cells = rng.permutation(num_pages * ps)[:8]
    page_ids = np.concatenate([cells // ps, np.full(4, num_pages)])
    slot_ids = np.concatenate([cells % ps, [cells[0] % ps, 0, 3, 1]])
    order = rng.permutation(rows)
    page_ids = page_ids[order].astype(np.int32)
    slot_ids = slot_ids[order].astype(np.int32)
    k_new = rng.standard_normal((rows, kvh, hd)).astype(np.float32)
    v_new = rng.standard_normal((rows, kvh, hd)).astype(np.float32)
    spec = tattn.AttnSpec(d_model=16, num_heads=2, num_kv_heads=kvh,
                          head_dim=hd)
    dt = getattr(torch, kind)
    pool = tattn.make_paged_pool(spec, num_pages, ps, dt, device="cpu")
    assert pool["k"].shape[0] == num_pages + 1
    assert tattn.drop_page(pool) == num_pages
    for leaf in pool.values():  # a non-zero pool: untouched cells must stay
        leaf.copy_(torch.from_numpy(rng.standard_normal(leaf.shape)).to(
            leaf.dtype) if leaf.dtype != torch.int8 else torch.from_numpy(
            rng.integers(-127, 128, leaf.shape, dtype=np.int8)))
    masked = {n: t.clone() for n, t in pool.items()}
    jpool = {n: jnp.asarray(np.asarray(t[:num_pages].float()).astype(
        jnp.bfloat16) if t.dtype == torch.bfloat16 else t[:num_pages].numpy())
        for n, t in pool.items()}

    args = (torch.from_numpy(page_ids), torch.from_numpy(slot_ids),
            torch.from_numpy(k_new), torch.from_numpy(v_new))
    tattn._pool_scatter(pool, *args)
    _masked_scatter(masked, *args)
    want = jattn._pool_scatter(jpool, jnp.asarray(page_ids),
                               jnp.asarray(slot_ids), jnp.asarray(k_new),
                               jnp.asarray(v_new))
    for name, leaf in pool.items():
        real = leaf[:num_pages]
        assert torch.equal(real, masked[name][:num_pages]), name
        jw = to_torch(np.asarray(want[name]), device="cpu")
        assert real.dtype == jw.dtype and torch.equal(real, jw), name


def test_no_page_table_names_the_spare_page():
    cfg = tkv.PagedKVConfig(page_size=4, num_pages=10, max_batch=3,
                            max_seq_len=40)
    kv = tkv.KVCacheManager(cfg)
    rng = np.random.default_rng(0)
    lens = {}
    for _ in range(200):
        slot = int(rng.integers(0, cfg.max_batch))
        if slot in lens and rng.random() < 0.3:
            kv.free_slot(slot)
            del lens[slot]
            continue
        want = min(lens.get(slot, 0) + int(rng.integers(1, 9)),
                   cfg.max_seq_len)
        try:
            kv.ensure(slot, want)
            lens[slot] = want
        except tkv.OutOfPages:
            pass
        table = kv.page_table_array()
        assert table.min() >= 0 and table.max() < cfg.num_pages
    assert any(lens.values())
    spec = tattn.AttnSpec(d_model=16, num_heads=2, num_kv_heads=2,
                          head_dim=8)
    pool = tattn.make_paged_pool(spec, cfg.num_pages, cfg.page_size,
                                 device="cpu")
    assert tattn.drop_page(pool) == cfg.num_pages


@pytest.mark.parametrize("fn", [
    "model.make_paged_cache", "transformer.make_paged_cache",
    "attention.make_cache", "attention.make_paged_pool",
    "layers.rmsnorm_init", "layers.rope_frequencies"])
def test_allocating_entry_points_default_to_cuda(fn):
    cfg = treg.smoke_config(ARCH)
    spec = ttf.attn_spec(cfg, "swa")
    call = {
        "model.make_paged_cache": lambda **kw: TM.make_paged_cache(
            cfg, 4, 2, 1, **kw)[0]["layer_0"]["k"],
        "transformer.make_paged_cache": lambda **kw: ttf.make_paged_cache(
            cfg, 4, 2, 1, **kw)[0]["layer_0"]["v"],
        "attention.make_cache": lambda **kw: tattn.make_cache(
            spec, 1, 4, **kw)["k"],
        "attention.make_paged_pool": lambda **kw: tattn.make_paged_pool(
            spec, 4, 2, **kw)["k"],
        "layers.rmsnorm_init": lambda **kw: tlayers.rmsnorm_init(8, **kw)["g"],
        "layers.rope_frequencies": lambda **kw: tlayers.rope_frequencies(
            8, 1e4, **kw),
    }[fn]
    assert call(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def _decisions(mod_sch, mod_kv, seed):
    """Stub-executor trace of one scheduler copy: every decision as plain
    tuples, plus the final outputs."""
    rng = np.random.default_rng(seed)
    kv = mod_kv.KVCacheManager(mod_kv.PagedKVConfig(
        page_size=4, num_pages=10, max_batch=3, max_seq_len=48))
    sched = mod_sch.Scheduler(kv, prefill_chunk=6)
    for rid in range(7):
        plen = int(rng.integers(1, 20))
        sched.submit(mod_sch.Request(
            rid=rid, prompt=[rid] * plen,
            max_new_tokens=int(rng.integers(1, 20)),
            arrival=int(rng.integers(0, 8))))
    trace = []
    while sched.has_work:
        d = sched.next_decision()
        if d is None:
            trace.append(("idle",))
        elif isinstance(d, mod_sch.PrefillChunk):
            trace.append(("prefill", d.seq.rid, d.seq.slot, d.start,
                          d.length))
            sched.completed_prefill(d)
            if not d.seq.prefilling:
                sched.append_token(d.seq, d.seq.rid * 100)
        else:
            trace.append(("decode",) + tuple((s.rid, s.slot, s.kv_len)
                                             for s in d.seqs))
            for s in d.seqs:
                sched.append_token(s, s.rid * 100 + len(s.out_tokens))
        trace.append(("retired",) + tuple(s.rid
                                          for s in sched.retire_finished()))
    return trace, sched.stats.evicted


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_copy_makes_jax_decisions(seed):
    want = _decisions(jsch, jkv, seed)
    got = _decisions(tsch, tkv, seed)
    assert got == want
    assert len(want[0]) > 10


def test_engine_refuses_unported_features():
    # tensor parallelism is ported: the config constructs, and an engine
    # at tp=2 needs a process group of world size 2, as JAX's engine needs
    # tp devices (repro.sharding.tp.make_serve_mesh)
    ecfg = tserve.EngineConfig(tp=2, **ECFG)
    assert ecfg.tp == 2
    assert not torch.distributed.is_initialized()
    cfg = _tcfg("compressed", "int8")
    params = tserve.pack_params(
        TM.init(cfg, torch.Generator().manual_seed(0)), cfg)
    with pytest.raises(ValueError, match="torch.distributed"):
        tserve.ServeEngine(params, cfg, ecfg, device="cpu")
    assert tserve.EngineConfig(async_loop=True).async_loop
    # the engine features of the JAX engine construct
    plan = tfl.FaultPlan(seed=1, step_error_rate=0.1)
    for kw in ({"prefix_cache": True}, {"speculate": 3},
               {"faults": plan}):
        ecfg = tserve.EngineConfig(**kw)
        assert all(getattr(ecfg, k) == v for k, v in kw.items())
