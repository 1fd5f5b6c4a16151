"""The dry run and what it counts, held against the JAX package.

- ``configs.shapes``: ``input_specs`` (meta tensors) and ``applicable``
  equal JAX's for every arch and shape;
- ``model.param_count`` (the port's own init, fake tensors),
  ``analysis.model_flops_estimate`` / ``model_bytes_estimate`` equal
  JAX's for every registered arch at full size;
- ``launch.op_cost``: the smoke ``prefill_step``'s FLOPs equal JAX's
  ``jaxpr_cost.of_function`` (the SSM archs within their einsums'
  contraction order, below); the train step's relation to JAX's;
- per-rank resident bytes of every arch, smoke and full, on 16x16 and
  2x16x16, equal the bytes of JAX's ``rules`` shard shapes on a
  ``jax.sharding.AbstractMesh``;
- the dry ``Mesh``'s collective counts and bytes of a smoke step equal a
  real 2x2 gloo run's, rank for rank;
- the dry cells: the live-bytes tracker, the kernels' recorded costs on
  fake tensors, the TP degree of a serving cell, skipped cells' reasons,
  the roofline terms.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import registry as jreg, shapes as jshp
from repro.launch import analysis as janalysis, jaxpr_cost
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.runtime import steps as jsteps
from repro.sharding import rules as jrules

from repro_torch.configs import registry as treg, shapes as tshp
from repro_torch.core import linear as tlin
from repro_torch.kernels import ops, roofline
from repro_torch.launch import analysis, dryrun, op_cost
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import steps as tsteps
from repro_torch.sharding import ctx

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = tuple(jreg.ARCH_IDS)
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
SSM = ("jamba-1.5-large-398b", "mamba2-780m")


def _cfgs(arch, size):
    if size == "smoke":
        return jreg.smoke_config(arch), treg.smoke_config(arch)
    return jreg.get(arch), treg.get(arch)


_FAKE: dict = {}


def _port_meta(arch, size):
    """The port's own init of ``arch`` as meta tensors (drawn once under
    a FakeTensorMode: nothing is allocated)."""
    if (arch, size) not in _FAKE:
        with FakeTensorMode():
            p = TM.init(_cfgs(arch, size)[1],
                        torch.Generator().manual_seed(0))
        _FAKE[arch, size] = dryrun.tree.tree_map(dryrun._meta, p)
    return _FAKE[arch, size]


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_equal_jax(arch):
    jc, tc = jreg.get(arch), treg.get(arch)
    assert list(tshp.SHAPES) == list(jshp.SHAPES)
    for name, js in jshp.SHAPES.items():
        ts = tshp.SHAPES[name]
        assert dataclasses.astuple(ts) == dataclasses.astuple(js)
        assert tshp.applicable(tc, ts) == jshp.applicable(jc, js)
        want = jshp.input_specs(jc, js)
        got = tshp.input_specs(tc, ts)
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(v.shape)
            assert str(got[k].dtype).removeprefix("torch.") == str(v.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_estimates_equal_jax(arch):
    jc, tc = jreg.get(arch), treg.get(arch)
    jp = jax.eval_shape(lambda k: JM.init(jc, k), jax.random.PRNGKey(0))
    assert TM.param_count(_port_meta(arch, "full")) == JM.param_count(jp)
    for name, js in jshp.SHAPES.items():
        ts = tshp.SHAPES[name]
        assert analysis.model_flops_estimate(tc, ts) \
            == janalysis.model_flops_estimate(jc, js)
        assert analysis.model_bytes_estimate(tc, ts) \
            == janalysis.model_bytes_estimate(jc, js)


def _batch(jc, tc, b, s, train):
    jb = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    tb = {"tokens": torch.zeros((b, s), dtype=torch.int32)}
    if train:
        jb["labels"] = jb["tokens"]
        tb["labels"] = torch.zeros((b, s), dtype=torch.int32)
    if jc.frontend == "audio":
        shape = (b, jc.max_source_positions, jc.d_model)
        jb["audio_embeds"] = jax.ShapeDtypeStruct(shape, jnp.dtype(jc.dtype))
        tb["audio_embeds"] = torch.zeros(shape,
                                         dtype=getattr(torch, tc.dtype))
    return jb, tb


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_flops_equal_jax(arch):
    """The smoke prefill step's counted FLOPs equal JAX's jaxpr count.
    The SSM archs' SSD scan contracts its 3- and 4-operand einsums in
    another order than JAX's (two einsums in the port where JAX has one
    4-operand einsum), which counts other products: within 2% there."""
    jc, tc = _cfgs(arch, "smoke")
    b, s = 2, 64
    jb, tb = _batch(jc, tc, b, s, False)
    jp = jax.eval_shape(lambda k: JM.init(jc, k), jax.random.PRNGKey(0))
    want = jaxpr_cost.of_function(jsteps.bind(jsteps.prefill_step, jc, s),
                                  jp, jb)["flops"]
    tp = TM.init(tc, torch.Generator().manual_seed(0))
    got = op_cost.of_function(tsteps.prefill_step, tc, s, tp, tb)
    if arch in SSM:
        assert abs(got["flops"] / want - 1) < 0.02, (got, want)
    else:
        assert got["flops"] == want
    assert got["bytes"] >= got["bytes_dots"] > 0


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "granite-moe-3b-a800m"])
def test_train_step_flops_relation_to_jax(arch, remat):
    """The loss's forward FLOPs are JAX's; a whole train step (forward,
    remat's recompute, backward, AdamW) counts exactly one LM-head
    product, 2 * B * S * V * D, fewer than JAX's jaxpr, with remat on or
    off: the gradient of JAX's chunked cross entropy (a ``lax.scan``
    over checkpointed chunks) holds one more [B*S, D] x [D, V] dot than
    the port's checkpointed chunk loop runs."""
    jc, tc = _cfgs(arch, "smoke")
    jc = dataclasses.replace(jc, remat=remat)
    tc = dataclasses.replace(tc, remat=remat)
    b, s = 2, 64
    jb, tb = _batch(jc, tc, b, s, True)
    jp = jax.eval_shape(lambda k: JM.init(jc, k), jax.random.PRNGKey(0))
    jo = jax.eval_shape(lambda p: jadamw.init(p, jadamw.AdamWConfig()), jp)
    want = jaxpr_cost.of_function(jsteps.bind(
        jsteps.train_step, jc, jadamw.AdamWConfig()), jp, jo, jb)["flops"]
    want_fwd = jaxpr_cost.of_function(lambda p, x: JM.loss_fn(p, jc, x),
                                      jp, jb)["flops"]
    tp = TM.init(tc, torch.Generator().manual_seed(0))
    to = tadamw.init(tp, tadamw.AdamWConfig())
    got_fwd = op_cost.of_function(lambda: TM.loss_fn(tp, tc, tb))["flops"]
    got = op_cost.of_function(tsteps.train_step, tc, tadamw.AdamWConfig(),
                              tp, to, tb)["flops"]
    assert got_fwd == want_fwd
    assert want - got == 2 * b * s * tc.vocab_size * tc.d_model


def _jax_resident(arch, size, sizes, opt_dtype):
    jc = _cfgs(arch, size)[0]
    p = jax.eval_shape(lambda k: JM.init(jc, k), jax.random.PRNGKey(0))
    o = jax.eval_shape(lambda q: jadamw.init(q, jadamw.AdamWConfig(
        state_dtype=opt_dtype)), p)
    mesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    psh = jrules.params_shardings(p, mesh)
    osh = jrules.opt_state_shardings(o, psh, mesh)
    leaves = jax.tree_util.tree_leaves(p) + jax.tree_util.tree_leaves(o)
    shards = jax.tree_util.tree_leaves(psh) + jax.tree_util.tree_leaves(osh)
    assert len(leaves) == len(shards)
    return sum(int(np.prod(sh.shard_shape(x.shape))) * x.dtype.itemsize
               for x, sh in zip(leaves, shards))


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_resident_bytes_equal_jax_shard_shapes(mesh, size, monkeypatch):
    """Params + int8 (and fp32) AdamW state a rank holds, every arch, vs
    the bytes of JAX's rule shardings' shard shapes on an AbstractMesh
    (JAX's rules read the mesh's axis sizes through ``devices``, which an
    AbstractMesh lacks: the test gives them ``axis_sizes``)."""
    monkeypatch.setattr(jrules, "_axis", lambda m, name: dict(
        zip(m.axis_names, m.axis_sizes)).get(name, 1))
    sizes = MESHES[mesh]
    for arch in ARCHS:
        for opt in (("int8", "float32") if arch == ARCHS[0] else ("int8",)):
            got = dryrun.resident_bytes(
                _port_meta(arch, size),
                tadamw.AdamWConfig(state_dtype=opt), sizes)
            assert got == _jax_resident(arch, size, sizes, opt), (arch, opt)


RANK = r'''
import json, sys, torch
from repro_torch.configs import registry
from repro_torch.core.linear import SparsityConfig
from repro_torch.launch import dryrun
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.runtime import steps, train_loop
from repro_torch.sharding import ctx, dist as rd, rules
import dataclasses
root = sys.argv[1]
rank, world = rd.init("gloo")
torch.set_num_threads(1)
cfg = dataclasses.replace(registry.smoke_config("h2o-danube-3-4b"),
    sparsity=SparsityConfig(pattern=(6, 8), mode="masked"))
opt = adamw.AdamWConfig(state_dtype="int8")
mesh = ctx.Mesh((2, 2), ("data", "model"), device="cpu")
params, state, lay = train_loop._sharded_init(
    TM.init(cfg, torch.Generator().manual_seed(0)), opt, mesh)
b, s = 8, 32
batch = {"tokens": torch.zeros((b // 2, s), dtype=torch.int32),
         "labels": torch.zeros((b // 2, s), dtype=torch.int32)}
ctx.reset_counts()
steps.train_step(cfg, opt, params, state, batch, layout=lay)
train = {"count": ctx.collective_count(), "wire": ctx.wire_bytes(),
         "kinds": ctx.collectives_by_kind(),
         "resident": rules.resident_bytes(params)
         + rules.resident_bytes(state)}
# one sequence-sharded decode step at batch 1, S = 64 over (data, model)
scfg = registry.smoke_config("h2o-danube-3-4b")
sparams = steps.serve_params(TM.init(scfg, torch.Generator().manual_seed(0)),
                             scfg, mesh)
cache, lay = steps.seq_cache(scfg, 1, 64, mesh, device="cpu")
ctx.reset_counts()
steps.serve_step(scfg, sparams, torch.zeros((1,), dtype=torch.int32), cache,
                 torch.full((1,), 40, dtype=torch.int32), mesh=mesh,
                 layout=lay)
serve = {"count": ctx.collective_count(), "wire": ctx.wire_bytes(),
         "kinds": ctx.collectives_by_kind(),
         "resident": rules.resident_bytes(sparams)
         + rules.resident_bytes(cache)}
json.dump({"train": train, "serve": serve}, open(f"{root}/r{rank}.json", "w"))
'''


@pytest.fixture(scope="module")
def real_ranks():
    """Four real gloo ranks over (data 2, model 2): each one's counts of
    a masked 6:8 smoke train step and of a sequence-sharded smoke decode
    step."""
    import json
    from repro_torch.sharding import dist as tdist
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    with tempfile.TemporaryDirectory() as root:
        tdist.launch([sys.executable, "-c", RANK, root], 4, env=env,
                      cwd=ROOT, timeout=120)
        return [json.load(open(f"{root}/r{r}.json")) for r in range(4)]


def test_dry_mesh_counts_equal_a_real_gloo_run(real_ranks):
    """A masked 6:8 smoke step with int8 moments over (data 2, model 2):
    each of four real gloo ranks' collective count, bytes handed to the
    collectives, per-kind tallies and resident bytes equal the dry run's
    as that rank."""
    real = [r["train"] for r in real_ranks]
    cfg = dataclasses.replace(
        treg.smoke_config("h2o-danube-3-4b"),
        sparsity=tlin.SparsityConfig(pattern=(6, 8), mode="masked"))
    for r in range(4):
        dry = dryrun.train_step_dry(cfg, tadamw.AdamWConfig(
            state_dtype="int8"), 8, 32, {"data": 2, "model": 2}, rank=r,
            device="cpu")
        assert dry["collective_count"] == real[r]["count"] > 0
        assert dry["wire_bytes"] == real[r]["wire"]
        assert dry["collectives"] == real[r]["kinds"]
        assert dry["resident_bytes"] == real[r]["resident"]


def test_dry_mesh_counts_equal_a_real_gloo_serve_step(real_ranks):
    """The sequence-sharded decode step (danube smoke, batch 1, S = 64
    over (data 2, model 2)): each real rank's collective count, bytes,
    per-kind tallies and resident bytes (weight shard + cache piece)
    equal the dry run's as that rank."""
    cfg = treg.smoke_config("h2o-danube-3-4b")
    spec = tshp.ShapeSpec("long", 64, 1, "decode")
    sizes = {"data": 2, "model": 2}
    assert dryrun.seq_sharded(spec, sizes)
    for r in range(4):
        real = real_ranks[r]["serve"]
        dry = dryrun.serve_step_dry(cfg, spec, sizes, rank=r, device="cpu")
        assert dry["seq_axes"] == ["data", "model"]
        assert dry["seq_len_local"] == 16 and dry["tp"] == 2
        assert dry["collective_count"] == real["count"] > 0
        assert dry["wire_bytes"] == real["wire"]
        assert dry["collectives"] == real["kinds"]
        assert dry["resident_bytes"] == real["resident"]


def test_long_500k_cache_a_rank_is_the_whole_over_256():
    """danube ``long_500k`` on 16x16: the cell runs the sequence-sharded
    step, and a rank's attention cache is the whole bf16 cache (24
    layers, 8 KV heads of 120, S = 524288, K and V) over 256 ranks: S
    over (data, model), 2048 positions a rank."""
    rec = dryrun.run_cell("h2o-danube-3-4b", "long_500k", False,
                          verbose=False)
    cfg = treg.get("h2o-danube-3-4b")
    whole = (cfg.num_layers * 2 * 524288 * cfg.num_kv_heads
             * cfg.resolved_head_dim * 2)
    assert rec["status"] == "ok", rec
    assert rec["cache_bytes"] * 256 == whole
    assert rec["seq_axes"] == ["data", "model"]
    assert rec["seq_len_local"] == 2048 and rec["local_batch"] == 1
    assert rec["tp"] == 8 and rec["fits"]
    assert rec["resident_bytes"] > rec["cache_bytes"]


def test_split_halves_a_rank_s_flops_at_model_2():
    """The train step splits its compute along ``model``: the smoke
    danube step's FLOPs a rank over (data 1, model 2) are at most 0.6 of
    (data 1, model 1)'s (the linears, the attention and the LM head
    halve; the norms, the embedding and AdamW's pieces do not), and
    ``sequence_parallel`` keeps them while counting the reduce-scatters
    of its row-parallel sums."""
    cfg = dataclasses.replace(
        treg.smoke_config("h2o-danube-3-4b"),
        sparsity=tlin.SparsityConfig(pattern=(6, 8), mode="masked"))
    opt = tadamw.AdamWConfig(state_dtype="int8")
    one = dryrun.train_step_dry(cfg, opt, 8, 32, {"data": 1, "model": 1},
                                device="cpu")
    two = dryrun.train_step_dry(cfg, opt, 8, 32, {"data": 1, "model": 2},
                                device="cpu")
    sp = dryrun.train_step_dry(
        dataclasses.replace(cfg, sequence_parallel=True), opt, 8, 32,
        {"data": 1, "model": 2}, device="cpu")
    assert (one["tp"], two["tp"], two["replicas"]) == (1, 2, 1)
    assert two["counts"]["flops"] <= 0.6 * one["counts"]["flops"]
    assert two["peak_bytes"] < one["peak_bytes"]
    assert sp["counts"]["flops"] == two["counts"]["flops"]
    assert "reduce-scatter" in sp["collectives"]
    assert "reduce-scatter" not in two["collectives"]
    four = dryrun.train_step_dry(cfg, opt, 8, 32, {"data": 1, "model": 4},
                                 device="cpu")
    assert (four["tp"], four["replicas"]) == (2, 2)   # two KV heads


def test_live_bytes_tracks_storages_and_frees():
    live = dryrun.LiveBytes()
    with FakeTensorMode():
        a = torch.empty(1000, dtype=torch.float32)
        live.track(a)
        with live:
            b = a * 2             # +4000
            c = b.view(10, 100)   # a view: no new storage
            del b
            d = torch.empty(500, dtype=torch.float32)
            del c, d
        assert live.peak == 4000 + 4000 + 2000
        assert live.now == 4000
    del a


def test_kernels_on_fake_tensors_record_their_cost():
    """A compressed smoke decode cell at (data 2, model 2): every linear
    goes through B1's dispatch on fake tensors, returns an empty output
    and records ``roofline.op_cost``; the plain version never runs."""
    cfg = dataclasses.replace(
        treg.smoke_config("h2o-danube-3-4b"),
        sparsity=tlin.SparsityConfig(pattern=(6, 8), mode="compressed",
                                     recipe="int8"))
    spec = tshp.ShapeSpec("d", 64, 4, "decode")
    cell = dryrun.serve_step_dry(cfg, spec, {"data": 2, "model": 2},
                                 device="cpu")
    assert cell["tp"] == 2 and cell["local_batch"] == 2
    k = cell["kernels"]["compressed_matmul"]
    layers = cfg.num_layers
    assert k["calls"] == 7 * layers + 1  # q k v o gate up down, lm head
    assert k["bytes"] > 0 and k["flops"] > 0
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    one = roofline.op_cost("compressed_matmul", rows=2,
                           m=cfg.num_heads * hd // 2, k=d, pattern="6:8",
                           adt="int8", wdt="int8", odt="float32")
    assert one.bytes > 0 and k["bytes"] > one.bytes
    ops.reset_dry_costs()


def test_serving_tp_degree_and_skips(monkeypatch):
    """The serving TP degree is the model axis' largest divisor the
    config divides into; every sub-quadratic arch's long_500k cell runs
    (reaches the serve step: none is skipped), full attention stacks
    are skipped with JAX's reason."""
    assert dryrun.serve_tp(treg.get("h2o-danube-3-4b"), 16) == 8
    assert dryrun.serve_tp(treg.get("phi3-medium-14b"), 16) == 2
    assert dryrun.serve_tp(treg.get("whisper-small"), 16) == 1
    assert not hasattr(dryrun, "SEQ_SHARDED")

    class Ran(Exception):
        pass

    def reached(*a, **k):
        raise Ran

    monkeypatch.setattr(dryrun, "serve_step_dry", reached)
    ran = []
    for arch in ARCHS:
        jok, jreason = jshp.applicable(jreg.get(arch),
                                       jshp.SHAPES["long_500k"])
        try:
            rec = dryrun.run_cell(arch, "long_500k", True, verbose=False)
        except Ran:
            ran.append(arch)
            continue
        assert not jok and rec == {
            "arch": arch, "shape": "long_500k", "mesh": "2x16x16",
            "levers": {}, "status": "skipped", "reason": jreason}
    assert sorted(ran) == sorted(a for a in ARCHS
                                 if jreg.get(a).sub_quadratic)
    assert len(ran) == 5


def test_roofline_terms_from_counts():
    coll = {"all-gather": {"count": 2, "bytes": 100, "wire": 1500.0},
            "all-reduce": {"count": 1, "bytes": 8, "wire": 14.0}}
    r = analysis.from_counts({"flops": 1e12, "bytes": 5e9,
                              "bytes_dots": 2e9}, coll, 4,
                             model_flops=2e12, model_bytes=1e9)
    assert r.flops == 4e12 and r.hbm_bytes == 8e9
    assert r.coll_bytes == 1514.0
    assert r.t_compute == 4e12 / (4 * analysis.PEAK_FLOPS)
    assert r.t_memory == 8e9 / (4 * analysis.HBM_BW)
    assert r.t_collective == 1514.0 / analysis.LINK_BW
    assert r.dominant == "compute" and r.useful_flops_ratio == 0.5
    d = r.to_dict()
    assert d["dominant"] == "compute" and d["raw_counts"]["bytes"] == 5e9


def test_ring_wire_costs():
    """The dry mesh's per-kind tallies use JAX's ring multipliers over
    the group: all-gather (n-1)/n of the gathered tensor, reduce-scatter
    (n-1)/n of its input, all-reduce 2(n-1)/n, a shift once."""
    mesh = ctx.Mesh.abstract({"data": 4, "model": 2}, dry=True)
    ctx.reset_counts()
    x = torch.zeros(8, 6)
    assert mesh.all_gather(x, "data", 0).shape == (32, 6)
    assert mesh.reduce_scatter(x, "data", 0).shape == (2, 6)
    assert mesh.all_reduce(x, ("data", "model")).shape == (8, 6)
    assert mesh.shift(x, "model").shape == (8, 6)
    kinds = ctx.collectives_by_kind()
    n = 8 * 6 * 4
    assert kinds["all-gather"]["wire"] == n * 3
    assert kinds["reduce-scatter"]["wire"] == n * 3 / 4
    assert kinds["all-reduce"]["wire"] == 2 * n * 3 / 4 + 2 * n * 1 / 2
    assert kinds["collective-permute"]["wire"] == n
    assert ctx.collective_count() == 5 and ctx.wire_bytes() == 5 * n
    ctx.reset_counts()


def test_cell_options(monkeypatch):
    """``run_cell``'s options on smoke-sized cells (the registry swapped
    for its smoke configs at 4 layers): int8 KV halves the decode cache a rank holds,
    single-level remat counts one fewer forward's FLOPs, two microbatches
    keep the step's FLOPs, and ``--sparse`` serves through B1 (fake
    tensors: its calls recorded, no plain version run)."""
    import types
    monkeypatch.setattr(dryrun, "registry", types.SimpleNamespace(
        get=lambda a: dataclasses.replace(treg.smoke_config(a),
                                          num_layers=4),
        ARCH_IDS=treg.ARCH_IDS))
    monkeypatch.setitem(dryrun.shp.SHAPES, "train_4k",
                        tshp.ShapeSpec("train_4k", 32, 32, "train"))
    monkeypatch.setitem(dryrun.shp.SHAPES, "decode_32k",
                        tshp.ShapeSpec("decode_32k", 64, 32, "decode"))
    arch = "h2o-danube-3-4b"

    def cell(shape, **kw):
        rec = dryrun.run_cell(arch, shape, False, verbose=False, **kw)
        assert rec["status"] == "ok", rec
        return rec
    base, kv8 = cell("decode_32k"), cell("decode_32k", kv_int8=True)
    assert kv8["resident_bytes"] < base["resident_bytes"]
    train = cell("train_4k")
    assert cell("train_4k", no_remat2=True)["flops_per_rank"] \
        < train["flops_per_rank"]
    assert cell("train_4k", grad_accum=2)["flops_per_rank"] \
        == train["flops_per_rank"]
    sp = cell("train_4k", seq_par=True)
    assert sp["sequence_parallel"] and sp["tp"] == 2
    assert sp["flops_per_rank"] == train["flops_per_rank"]
    sparse = cell("decode_32k", sparse=(6, 8), precision="int8")
    assert sparse["kernels"]["compressed_matmul"]["calls"] > 0
    assert not base["kernels"]
