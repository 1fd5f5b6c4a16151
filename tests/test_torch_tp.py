"""Tensor-parallel serving in one process: the port's shard functions held
against the JAX package's (``repro.sharding.tp``, ``repro.core.compressed``).

* ``split_out`` / ``split_k`` give JAX's shards bit for bit over the
  (2N-2):2N family, nibble-packed 'w4' values included, and ``split_k``
  refuses a straddling group with JAX's message.
* ``shard_params`` of a converted JAX tree equals, leaf by leaf, the slice
  JAX's ``serve_param_specs`` names (danube compressed, granite's expert
  stacks, jamba's head-sharded SSM leaves and mixer norm); the slided
  operand's shards are ``sparse_operand`` of the sliced Phi(W) and decode
  back to JAX's ``w_slided`` slices.
* ``validate`` refuses what JAX refuses, with its messages; the page
  accounting of a tp=2 config holds under eviction; the collectives and
  ``linear.apply(reduce_out=True)`` are the identity without a context;
  B3's ``act_absmax`` input (plain version) equals JAX's oracle.

The collectives and the engine over two ranks are in
``test_torch_tp_engine.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import compressed as jcomp, linear as jlin, packer as jpacker
from repro.core.patterns import (Pattern, SlideDecomposition,
                                 TWO_FOUR as JTWO_FOUR)
from repro.kernels import ops as jops
from repro.models import model as JM
from repro.runtime import serve_loop as jserve
from repro.sharding import tp as jtp

from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import compressed as tcomp, linear as tlin, quant
from repro_torch.core.patterns import Pattern as TPattern
from repro_torch.core.patterns import SlideDecomposition as TDec
from repro_torch.core.patterns import TWO_FOUR
from repro_torch.kernels import fused_slide_matmul as tfsm, ops as tops
from repro_torch.models import model as TM
from repro_torch.runtime import kv_cache as tkv, serve_loop as tserve
from repro_torch.runtime.scheduler import (DecodeBatch, PrefillChunk,
                                           Request, Scheduler)
from repro_torch.sharding import tp as ttp

ARCH = "h2o-danube-3-4b"


# ------------------------------------------------------ split_out / split_k
def _jax_compressed(rng, out, k, z, l, packed):
    dec = SlideDecomposition(Pattern(z, l), JTWO_FOUR)
    if packed:  # int4-range integers, as 'w4' stores them
        w = rng.integers(-7, 8, size=(out, k)).astype(np.float32)
    else:
        w = rng.standard_normal((out, k)).astype(np.float32)
    w = np.asarray(jpacker.prune_to_pattern(w, dec.source))
    ws = np.asarray(jpacker.pack_slided(w, dec))
    if packed:
        ws = ws.astype(np.int8)
    return jcomp.compress(ws, dec, pack_values=packed)


def _port(c):
    return tcomp.CompressedSlided(
        to_torch(np.asarray(c.values), "cpu"),
        to_torch(np.asarray(c.indices), "cpu"), c.k, c.z, c.l, c.m, c.n,
        c.packed)


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "w4"])
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("pattern", [(2, 4), (4, 6), (6, 8), (8, 10)],
                         ids=lambda p: f"{p[0]}:{p[1]}")
def test_split_out_and_split_k_match_jax(pattern, shards, packed):
    z, l = pattern
    rng = np.random.default_rng(17 * l + shards)
    out, k = 4 * shards, l * 2 * shards
    jc = _jax_compressed(rng, out, k, z, l, packed)
    tc = _port(jc)
    for split in ("split_k", "split_out"):
        want = getattr(jcomp, split)(jc, shards)
        got = getattr(tcomp, split)(tc, shards)
        assert len(got) == len(want) == shards
        for g, w in zip(got, want):
            assert (g.k, g.packed) == (w.k, w.packed)
            np.testing.assert_array_equal(g.values.numpy(),
                                          np.asarray(w.values))
            np.testing.assert_array_equal(g.indices.numpy(),
                                          np.asarray(w.indices))
    # the K shards decompress to the K-slices of the whole
    full = tcomp.decompress_original(tc)
    for i, sh in enumerate(tcomp.split_k(tc, shards)):
        assert torch.equal(tcomp.decompress_original(sh),
                           full[:, i * k // shards:(i + 1) * k // shards])


def test_split_k_rejects_straddling_groups_as_jax():
    rng = np.random.default_rng(0)
    jc = _jax_compressed(rng, 4, 24, 6, 8, False)  # 3 groups of L=8
    with pytest.raises(ValueError) as want:
        jcomp.split_k(jc, 2)
    with pytest.raises(ValueError, match="straddle") as got:
        tcomp.split_k(_port(jc), 2)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="cannot split out"):
        tcomp.split_out(_port(jc), 3)


# ------------------------------------------------------------ shard_params
def _cfgs(arch, over, mode, recipe):
    jcfg = dataclasses.replace(jreg.smoke_config(arch), **over)
    tcfg = dataclasses.replace(treg.smoke_config(arch), **over)
    if mode != "dense":
        jcfg = dataclasses.replace(jcfg, sparsity=jlin.SparsityConfig(
            pattern=(6, 8), mode=mode, recipe=recipe, use_pallas=False))
        tcfg = dataclasses.replace(tcfg, sparsity=tlin.SparsityConfig(
            pattern=(6, 8), mode=mode, recipe=recipe))
    return jcfg, tcfg


def _jax_packed(jcfg):
    tree = JM.init(jcfg, jax.random.PRNGKey(0))
    if jcfg.sparsity.pattern is not None:
        tree = jserve.pack_params(tree, jcfg)
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_slice(leaf, spec, rank, tp):
    idx = []
    for dim, ax in enumerate(spec):
        if ax is None:
            idx.append(slice(None))
        else:
            step = leaf.shape[dim] // tp
            idx.append(slice(rank * step, (rank + 1) * step))
    return leaf[tuple(idx)]


def _port_leaf(tree, names, u=None):
    node = tree["units"][u] if u is not None else tree
    for n in (names[1:] if u is not None else names):
        node = node[n]
    return node


@pytest.mark.parametrize("arch,over,mode", [
    (ARCH, {}, "compressed"),
    ("granite-moe-3b-a800m", {}, "compressed"),
    ("jamba-1.5-large-398b", {}, "dense")],
    ids=["danube-compressed", "granite", "jamba"])
def test_shard_params_match_jax_specs(arch, over, mode):
    tp = 2
    jcfg, tcfg = _cfgs(arch, over, mode, "int8")
    jtree = _jax_packed(jcfg)
    specs = jtp.serve_param_specs(jtree, tp)
    tparams = params_from_jax(jtree, tcfg, device="cpu")
    shards = [ttp.shard_params(tparams, tcfg, r, tp) for r in range(tp)]
    leaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    spec_of = dict(jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0])
    seen = {"sharded": 0, "head": 0, "mixer_g": 0}
    for path, leaf in leaves:
        names = [str(getattr(k, "key", k)) for k in path]
        spec = spec_of[path]
        sharded = any(ax is not None for ax in spec)
        seen["sharded"] += sharded
        seen["head"] += names[-1] in ("conv_w", "A_log", "dt_bias", "D")
        seen["mixer_g"] += sharded and names[-1] == "g"
        for r in range(tp):
            want = _jax_slice(leaf, spec, r, tp)
            units = range(tcfg.num_units) if names[0] == "units" else [None]
            for u in units:
                got = _port_leaf(shards[r], names, u)
                w = want[u] if u is not None else want
                np.testing.assert_array_equal(
                    got.view(torch.int16).numpy() if got.dtype ==
                    torch.bfloat16 else got.numpy(),
                    w.view(np.int16) if w.dtype.name == "bfloat16" else w,
                    err_msg="/".join(names))
                # sharded leaves sit in storage of their own
                if sharded:
                    assert got.untyped_storage().nbytes() == got.nbytes
    assert seen["sharded"] > 0
    if arch.startswith("jamba"):
        assert seen["head"] > 0 and seen["mixer_g"] > 0


@pytest.mark.parametrize("recipe", ["int8", "w4"])
def test_slided_operand_shards_are_operands_of_sliced_phi(recipe):
    tp = 2
    jcfg, tcfg = _cfgs(ARCH, {}, "slided", recipe)
    jtree = JM.init(jreg.smoke_config(ARCH), jax.random.PRNGKey(0))
    jpacked = jax.tree_util.tree_map(np.asarray,
                                     jserve.pack_params(jtree, jcfg))
    tparams = tserve.pack_params(
        params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), tcfg,
                        device="cpu"), tcfg)
    specs = jtp.serve_param_specs(jpacked, tp)
    packed = recipe == "w4"
    checked = 0
    for r in range(tp):
        shard = ttp.shard_params(tparams, tcfg, r, tp)
        for blk, names in (("mixer", ("wq", "wo")),
                           ("ffn", ("w_up", "w_down"))):
            for name in names:
                spec = specs["units"]["layer_0"][blk][name]
                jleaf = jpacked["units"]["layer_0"][blk][name]
                want = _jax_slice(jleaf["w_slided"], spec["w_slided"], r,
                                  tp)[0]
                want_sw = _jax_slice(jleaf["s_w"], spec["s_w"], r, tp)[0]
                got = shard["units"][0]["layer_0"][blk][name]
                m = got["s_w"].shape[0]
                gk = want.shape[-1] * (2 if packed else 1)
                ws = tfsm.dense_from_operand(got["sp_values"], got["sp_meta"],
                                             m, gk, packed=packed)
                np.testing.assert_array_equal(ws.numpy(), want)
                np.testing.assert_array_equal(got["s_w"].numpy(), want_sw)
                vals, meta = tfsm.sparse_operand(torch.from_numpy(want.copy()),
                                                 packed=packed)
                assert torch.equal(got["sp_values"], vals)
                assert torch.equal(got["sp_meta"], meta)
                checked += 1
    assert checked == 8


# -------------------------------------------------------------- validate
def test_validate_refuses_what_jax_refuses():
    jcfg = jreg.smoke_config(ARCH)
    tcfg = treg.smoke_config(ARCH)
    ttp.validate(tcfg, 2)  # the smoke config is tp=2 compatible
    narrow = dict(num_heads=2, num_kv_heads=2, head_dim=12)
    cases = [({"num_kv_heads": 3}, 2, None, "num_kv_heads"),
             ({}, 8, None, "num_heads"),
             (narrow, 2, (6, 8), "straddle")]
    for over, tp, pattern, match in cases:
        jc = dataclasses.replace(jcfg, **over)
        tc = dataclasses.replace(tcfg, **over)
        if pattern:
            jc = dataclasses.replace(jc, sparsity=jlin.SparsityConfig(
                pattern=pattern, mode="compressed"))
            tc = dataclasses.replace(tc, sparsity=tlin.SparsityConfig(
                pattern=pattern, mode="compressed"))
        with pytest.raises(ValueError) as want:
            jtp.validate(jc, tp)
        with pytest.raises(ValueError, match=match) as got:
            ttp.validate(tc, tp)
        assert str(got.value) == str(want.value)
    jamba = dataclasses.replace(treg.smoke_config("jamba-1.5-large-398b"),
                                d_model=48)
    with pytest.raises(ValueError) as got:
        ttp.validate(jamba, 4)
    with pytest.raises(ValueError) as want:
        jtp.validate(dataclasses.replace(
            jreg.smoke_config("jamba-1.5-large-398b"), d_model=48), 4)
    assert str(got.value) == str(want.value) and "ssm heads" in str(got.value)


def test_shard_params_refuses_an_indivisible_dim():
    cfg = dataclasses.replace(treg.smoke_config(ARCH), vocab_size=129)
    params = {"lm_head": {"w": torch.zeros((129, 64))}}
    with pytest.raises(ValueError, match="cannot shard lm_head/w"):
        ttp.shard_params(params, cfg, 0, 2)


def test_engine_needs_an_initialized_group():
    assert not torch.distributed.is_initialized()
    cfg = treg.smoke_config(ARCH)
    params = TM.init(cfg, torch.Generator().manual_seed(0))
    for tp in (2, 4):
        with pytest.raises(ValueError, match=f"tp={tp} needs"):
            tserve.ServeEngine(params, cfg, tserve.EngineConfig(tp=tp),
                               device="cpu")


# ------------------------------------------------- per-shard page accounting
def test_per_shard_page_accounting_under_eviction():
    """Scheduler and page accounting invariants hold at tp=2 under forced
    eviction: the budget every rank replicates (host side)."""
    with pytest.raises(ValueError, match="shard count"):
        tkv.PagedKVConfig(tp=0)
    cfg = tkv.PagedKVConfig(page_size=4, num_pages=6, max_batch=3,
                            max_seq_len=20, tp=2)
    assert cfg.per_shard_page_tokens == 24
    assert tserve.EngineConfig(tp=2, num_pages=6).kv_config().tp == 2
    kv = tkv.KVCacheManager(cfg)
    sched = Scheduler(kv, prefill_chunk=8)
    rng = np.random.default_rng(0)
    for rid in range(4):
        sched.submit(Request(rid=rid, prompt=list(
            rng.integers(0, 100, size=int(rng.integers(4, 12)))),
            max_new_tokens=6, arrival=rid))
    steps = 0
    while sched.has_work and steps < 500:
        steps += 1
        d = sched.next_decision()
        kv.check()
        if d is None:
            continue
        if isinstance(d, PrefillChunk):
            sched.completed_prefill(d)
            if not d.seq.prefilling:
                sched.append_token(d.seq, int(rng.integers(0, 100)))
        else:
            assert isinstance(d, DecodeBatch)
            for seq in d.seqs:
                sched.append_token(seq, int(rng.integers(0, 100)))
        sched.retire_finished()
        kv.check()
    assert not sched.has_work, "traffic did not drain"
    assert sched.stats.evicted > 0, "pool was not small enough to evict"
    assert kv.pool.num_free == cfg.num_pages


# ------------------------------------------------ no context: the identity
def test_collectives_and_reduce_out_without_a_context():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32))
    assert ttp.current() is None and ttp.size() == 1 and ttp.rank() == 0
    assert ttp.reduce(x) is x and ttp.reduce_max(x) is x
    assert ttp.gather_last(x) is x
    assert torch.equal(ttp.argmax_tokens(x), torch.argmax(x, -1).int())
    g = {"g": torch.from_numpy(rng.standard_normal(64).astype(np.float32))}
    from repro_torch.models import layers
    assert torch.equal(ttp.rmsnorm(g, x), layers.rmsnorm(g, x))
    cfg = tlin.SparsityConfig(pattern=(6, 8), mode="compressed",
                              recipe="int8")
    p = tlin.prepare({"w": torch.from_numpy(
        rng.standard_normal((48, 64)).astype(np.float32))}, cfg)
    assert torch.equal(tlin.apply(p, x, cfg, reduce_out=True),
                       tlin.apply(p, x, cfg))
    # no context: an activation rides a reduce_out projection unrefused
    tlin.apply(p, x, cfg, activation="silu", reduce_out=True)


@pytest.mark.parametrize("recipe", ["int8", "w4", "fp8"])
@pytest.mark.parametrize("mode", ["compressed", "slided"])
def test_act_absmax_matches_jax(mode, recipe):
    """The kernels' plain versions quantize with a given per-token absmax
    as JAX's oracles do (B1's path outside the kernel, B3's input): int8
    and w4 bit for bit, fp8 within 1e-5 of the output scale."""
    rng = np.random.default_rng(5)
    k, m = 64, 48
    x = rng.standard_normal((6, k)).astype(np.float32)
    # a global absmax above each row's own, as a row-parallel shard sees
    aa = (np.abs(x).max(-1, keepdims=True)
          * rng.uniform(1.0, 2.0, (6, 1))).astype(np.float32)
    w = rng.standard_normal((m, k)).astype(np.float32)
    jcfg = jlin.SparsityConfig(pattern=(6, 8), mode=mode, recipe=recipe,
                               use_pallas=False)
    tcfg = tlin.SparsityConfig(pattern=(6, 8), mode=mode, recipe=recipe)
    jp = jlin.prepare({"w": w}, jcfg)
    tp_ = tlin.prepare({"w": torch.from_numpy(w)}, tcfg)
    dec = TDec(TPattern(6, 8), TWO_FOUR)
    xt, at = torch.from_numpy(x), torch.from_numpy(aa)
    if mode == "compressed":
        want = jops.compressed_matmul(
            x, jcomp.CompressedSlided(jp["values"], jp["indices"], k, 6, 8,
                                      2, 4, packed=recipe == "w4"),
            s_w=jp["s_w"], recipe=recipe, out_dtype=np.float32,
            use_pallas=False, act_absmax=aa)
        got = tops.compressed_matmul(
            xt, tcomp.CompressedSlided(tp_["values"], tp_["indices"], k, 6,
                                       8, 2, 4, packed=recipe == "w4"),
            s_w=tp_["s_w"], recipe=recipe, out_dtype=torch.float32,
            act_absmax=at)
    else:
        want = jops.slided_matmul_quant(
            x, jp["w_slided"], jp["s_w"], jcfg.decomposition(),
            recipe=recipe, out_dtype=np.float32, use_pallas=False,
            act_absmax=aa)
        got = tops.slided_matmul_quant(
            xt, tp_["sp_values"], tp_["sp_meta"], tp_["s_w"], dec,
            recipe=recipe, out_dtype=torch.float32, act_absmax=at)
        own = tops.slided_matmul_quant(
            xt, tp_["sp_values"], tp_["sp_meta"], tp_["s_w"], dec,
            recipe=recipe, out_dtype=torch.float32)
        # the rows' own absmax given == none given
        assert torch.equal(tops.slided_matmul_quant(
            xt, tp_["sp_values"], tp_["sp_meta"], tp_["s_w"], dec,
            recipe=recipe, out_dtype=torch.float32,
            act_absmax=quant.absmax(xt)), own)
        assert not torch.equal(got, own)
    want = np.asarray(want)
    if recipe == "fp8":
        # e4m3 products accumulate in fp32 in another order (as
        # test_torch_kernels holds fp8): 1e-5 of the output scale
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got.numpy(), want)
