"""The port's sharding rules held against the JAX package's, with no ranks.

For every arch of the registry, in ``smoke_config`` and at its full size,
on the meshes (data 4, model 2), (pod 2, data 2, model 2), (data 16,
model 16) and (pod 2, data 16, model 16): the port's spec of every leaf
equals JAX's, for the parameters (and ``serve_tp_only``), a training
batch, the one-shot cache (batch 8 and batch 1, where the sequence takes
the data-parallel axes) and the AdamW state in fp32 and int8.  JAX
stacks a model's units, the port keeps them as lists: a unit leaf's port
spec is JAX's with the unit dim dropped.  The full configs' port trees
are meta tensors shaped from ``jax.eval_shape`` (never allocated); at
smoke size the port's own init and cache are checked to have exactly
those paths and shapes.

Also: ``rules.shard`` / ``local_shape`` / ``offset`` on an abstract mesh,
``elastic``'s mesh shape rule, ``bubble_fraction`` and the compression's
``_quant_block`` / ``_dequant_block`` bit-equal to JAX's as
``compressed_crosspod_mean`` runs them (its ``shard_map`` called outside
``jit``: the scale a true division), ragged sizes included.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from repro.configs import registry as jreg
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.runtime import compression as jcomp
from repro.sharding import rules as jrules

from repro_torch import tree
from repro_torch.configs import registry as treg
from repro_torch.convert import _stacks
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import compression as tcomp, elastic, pipeline
from repro_torch.sharding import rules
from repro_torch.sharding.ctx import Mesh

MESHES = {"data4-model2": {"data": 4, "model": 2},
          "pod2-data2-model2": {"pod": 2, "data": 2, "model": 2},
          "data16-model16": {"data": 16, "model": 16},
          "pod2-data16-model16": {"pod": 2, "data": 16, "model": 16}}
SIZES = ("smoke", "full")


def _jax_mesh(sizes):
    n = int(np.prod(list(sizes.values())))
    devs = np.array(jax.devices() * n)[:n]
    return JMesh(devs.reshape(tuple(sizes.values())), tuple(sizes))


def _cfg(registry, arch, size):
    return registry.smoke_config(arch) if size == "smoke" else \
        registry.get(arch)


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch, size):
    """JAX's parameter, cache (batch 8 and 1) and batch shapes."""
    cfg = _cfg(jreg, arch, size)
    params = jax.eval_shape(lambda k: JM.init(cfg, k), jax.random.PRNGKey(0))
    caches = {b: jax.eval_shape(lambda b=b: JM.make_cache(cfg, b, 64))
              for b in (8, 1)}
    smoke = jreg.smoke_config(arch)
    batch = JSyntheticLM(dataclasses.replace(
        smoke, max_source_positions=cfg.max_source_positions,
        d_model=cfg.d_model), 8, 32, seed=0, host_index=0,
        host_count=1).batch_at(0)
    return cfg, params, caches, batch


def _meta(shape):
    return torch.empty(tuple(shape), dtype=torch.float32, device="meta")


def _unstack(jtree, keys):
    """A JAX tree of shapes as the port's tree of meta tensors: each
    stacked key's [U, ...] leaves split into a list of U subtrees."""
    def split(node, u):
        if isinstance(node, dict):
            return {k: split(v, u) for k, v in node.items()}
        return _meta(node.shape[1:])

    out = {}
    for k, v in jtree.items():
        if k in keys:
            n = jax.tree_util.tree_leaves(v)[0].shape[0]
            out[k] = [split(v, u) for u in range(n)]
        else:
            out[k] = jax.tree_util.tree_map(lambda s: _meta(s.shape), v)
    return out


def _port_params(arch, size):
    cfg, jp, _, _ = _jax_shapes(arch, size)
    return _unstack(jp, set(_stacks(jp, cfg)))


def _port_cache(arch, size, b):
    cfg, _, caches, _ = _jax_shapes(arch, size)
    jc = caches[b]
    if cfg.is_encoder_decoder:
        return {"self": _unstack({"self": jc["self"]}, {"self"})["self"],
                "enc_out": _meta(jc["enc_out"].shape)}
    return _unstack({"u": jc}, {"u"})["u"]


def _norm(spec, nd):
    spec = tuple(spec)
    return spec + (None,) * (nd - len(spec))


def _by_names(jtree, spec_of):
    """{path names: (JAX spec, stacked shape)} of a JAX tree of shapes."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        names = tuple(str(getattr(k, "key", getattr(k, "name", k)))
                      for k in path)
        out[names] = (spec_of(path, leaf), tuple(leaf.shape))
    return out


def _match(port_tree, port_specs, want, label):
    """Every port leaf's spec equals JAX's for the same path (the unit
    dim dropped where the port keeps a list)."""
    leaves = rules.stacked_leaves(port_tree)
    assert len(leaves) == len(port_specs)
    seen = set()
    for (names, shape, stacked), spec in zip(leaves, port_specs):
        jspec, jshape = want[tuple(str(n) for n in names)]
        assert jshape == shape, (label, names, jshape, shape)
        jspec = _norm(jspec, len(jshape))
        if stacked:
            assert jspec[0] is None, (label, names, jspec)
            jspec = jspec[1:]
        nd = len(shape) - stacked
        assert _norm(spec, nd) == jspec, (label, names, spec, jspec)
        seen.add(tuple(names))
    assert seen == set(want), (label, set(want) ^ seen)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_specs_equal_jax(arch, size, mesh_name):
    sizes = MESHES[mesh_name]
    jmesh, mesh = _jax_mesh(sizes), Mesh.abstract(sizes)
    cfg, jp, jcaches, jbatch = _jax_shapes(arch, size)
    tp = _port_params(arch, size)

    # parameters, and the tensor-parallel serving layout
    for tp_only, jrule in ((False, jrules.param_spec),
                           (True, jrules._tp_only_spec)):
        want = _by_names(jp, lambda p, l, r=jrule: r(p, l, jmesh))
        _match(tp, rules.params_shardings(tp, mesh, serve_tp_only=tp_only),
               want, (arch, size, mesh_name, "tp_only" * tp_only))

    # a training batch
    tbatch = {k: _meta(v.shape) for k, v in jbatch.items()}
    got = rules.batch_shardings(tbatch, mesh)
    for (k, v), spec in zip(sorted(jbatch.items()), got):
        assert _norm(spec, v.ndim) == _norm(
            jrules.batch_spec(v, jmesh), v.ndim), (k, spec)

    # the one-shot cache, batch 8 and batch 1
    for b, jc in jcaches.items():
        want = _by_names(jc, lambda p, l: jrules.cache_spec(p, l, jmesh))
        tc = _port_cache(arch, size, b)
        _match(tc, rules.cache_shardings(tc, mesh), want,
               (arch, size, mesh_name, "cache", b))

    # AdamW state, fp32 and int8: each field against JAX's
    jpsh = jrules.params_shardings(jp, jmesh)
    p_specs = rules.params_shardings(tp, mesh)
    n = len(p_specs)
    for dtype in ("float32", "int8"):
        jo = jax.eval_shape(lambda p: jadamw.init(
            p, jadamw.AdamWConfig(state_dtype=dtype)), jp)
        josh = jrules.opt_state_shardings(jo, jpsh, jmesh)
        to = tadamw.init(tp, tadamw.AdamWConfig(state_dtype=dtype))
        got = rules.opt_state_shardings(to, p_specs, mesh)
        assert got[0] == () and _norm(josh.step.spec, 0) == ()
        fields = ["mu", "nu"] + (["mu_scale", "nu_scale"]
                                 if dtype == "int8" else [])
        assert len(got) == 1 + n * len(fields)
        for i, f in enumerate(fields):
            jtree = getattr(jo, f)
            want = _by_names(jtree, lambda p, l: None)
            specs = dict(zip(
                [tuple(str(getattr(k, "key", k)) for k in path) for path, _ in
                 jax.tree_util.tree_flatten_with_path(jtree)[0]],
                [s.spec for s in jax.tree_util.tree_leaves(
                    getattr(josh, f), is_leaf=lambda x: hasattr(x, "spec"))]))
            want = {k: (specs[k], shp) for k, (_, shp) in want.items()}
            _match(getattr(to, f), got[1 + i * n:1 + (i + 1) * n], want,
                   (arch, size, mesh_name, dtype, f))


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_smoke_trees_have_jax_layout(arch):
    """The port's own init and one-shot cache have the paths and shapes
    the spec test builds from JAX's (so its meta trees stand for them)."""
    cfg = treg.smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    real = TM.init(cfg, gen)
    meta = _port_params(arch, "smoke")
    assert tree.paths(real) == tree.paths(meta)
    assert [x.shape for x in tree.leaves(real)] == \
        [x.shape for x in tree.leaves(meta)]
    for b in (8, 1):
        cache = TM.make_cache(cfg, b, 64, device="cpu")
        want = _port_cache(arch, "smoke", b)
        assert tree.paths(cache) == tree.paths(want)
        assert [x.shape for x in tree.leaves(cache)] == \
            [x.shape for x in tree.leaves(want)]


def test_unit_dim_is_never_sharded_and_refused():
    """No registered config shards a unit dim (the test above would have
    raised); a rule that did is refused, not silently dropped."""
    mesh = Mesh.abstract({"data": 2, "model": 2})
    # a stacked [U=2, 64] bias: JAX's rule puts 'model' on U
    bias = {"units": [{"b": _meta((64,))}, {"b": _meta((64,))}]}
    with pytest.raises(ValueError, match="unit dim"):
        rules.params_shardings(bias, mesh)


def test_shard_pieces_on_an_abstract_mesh():
    """Every rank's piece of every spec form is its block of the whole,
    and the pieces tile it exactly once."""
    sizes = {"pod": 2, "data": 2, "model": 2}
    x = torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)
    for spec in [(), ("model", "data"), (None, "model", "data"),
                 (None, None, "model"), (("pod", "data"), None, "model")]:
        cover = torch.zeros_like(x)
        for r in range(8):
            mesh = Mesh.abstract(sizes, rank=r)
            piece = rules.cut(x, spec, mesh)
            assert tuple(piece.shape) == rules.local_shape(x.shape, spec, mesh)
            assert rules.global_shape(piece.shape, spec, mesh) == x.shape
            idx = [slice(rules.offset(spec, d, x.shape[d], mesh),
                         rules.offset(spec, d, x.shape[d], mesh)
                         + piece.shape[d]) for d in range(3)]
            assert torch.equal(x[tuple(idx)], piece)
            cover[tuple(idx)] += 1
        reps = 8 // np.prod([sizes[a] for d in spec for a in rules.axes_of(d)]
                            or [1])
        assert torch.equal(cover, torch.full_like(x, float(reps))), spec
    # ('pod', 'data') on dim 0: pod is the major axis
    mesh = Mesh.abstract(sizes, rank=4 + 2)  # pod 1, data 1, model 0
    assert rules.offset((("pod", "data"),), 0, 8, mesh) == 6


@pytest.mark.parametrize("n,prefer,want", [
    (8, 16, (1, 8)), (12, 16, (3, 4)), (256, 16, (16, 16)),
    (6, 16, (3, 2)), (7, 16, (7, 1)), (4, 2, (2, 2)), (512, 16, (32, 16))])
def test_elastic_mesh_shape_rule(n, prefer, want):
    """JAX's halving: the model axis the largest of prefer, prefer/2, ...
    that divides the device count."""
    assert elastic.mesh_shape(n, prefer) == want
    model = prefer
    while model > 1 and n % model:
        model //= 2
    assert want == (n // model, model)


def test_bubble_fraction():
    assert abs(pipeline.bubble_fraction(4, 4) - 3 / 7) < 1e-9
    assert pipeline.bubble_fraction(1, 8) == 0.0


@pytest.mark.parametrize("n", [1, 7, 255, 256, 1000, 4096, 64 * 128 + 3])
def test_quant_block_bit_equals_jax(n):
    """``_quant_block`` and ``_dequant_block`` bit-equal to JAX's, ragged
    sizes (a padded last block) and zeros included."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * rng.uniform(0.01, 10, n)).astype(np.float32)
    x[rng.integers(0, n, max(1, n // 100))] = 0.0
    shape = (n,) if n % 2 else (2, n // 2)
    x = x.reshape(shape)
    jq, js = jcomp._quant_block(x)
    tq, ts = tcomp._quant_block(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jcomp._dequant_block(jq, js, shape)
    td = tcomp._dequant_block(tq, ts, shape)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_quant_block_scale_is_the_form_shard_map_runs():
    """The form matters: on enough blocks absmax/127 and absmax*(1/127)
    differ.  JAX's ``shard_map`` called outside ``jit`` (as
    ``compressed_crosspod_mean`` calls it) divides; under ``jit`` XLA
    multiplies by the reciprocal.  The port's scales are the division's."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(256 * 4000) * rng.uniform(0.1, 10, 256 * 4000)
         ).astype(np.float32)
    am = np.maximum(np.abs(x.reshape(-1, 256)).max(1, keepdims=True),
                    np.float32(1e-12))
    div = am / np.float32(127.0)
    mul = am * (np.float32(1.0) / np.float32(127.0))
    assert (div != mul).any()
    body = shard_map(jcomp._quant_block, mesh=jax.make_mesh((1,), ("pod",)),
                     in_specs=P(), out_specs=(P(), P()), check_rep=False)
    np.testing.assert_array_equal(np.asarray(body(x)[1]), div)
    np.testing.assert_array_equal(np.asarray(jax.jit(body)(x)[1]), mul)
    _, ts = tcomp._quant_block(torch.from_numpy(x))
    np.testing.assert_array_equal(ts.numpy(), div)


def test_mesh_context_and_constrain():
    """``use_mesh`` marks the mesh a step runs over and restores the
    previous one; ``constrain`` is the identity (no partitioner to hint)."""
    from repro_torch.sharding import ctx
    outer, inner = Mesh.abstract({"data": 2}), Mesh.abstract({"model": 4})
    assert ctx.current_mesh() is None
    with ctx.use_mesh(outer):
        with ctx.use_mesh(inner):
            assert ctx.current_mesh() is inner
        assert ctx.current_mesh() is outer
        x = torch.ones(4, 2)
        assert ctx.constrain(x, "dp", "model") is x
    assert ctx.current_mesh() is None
    with pytest.raises(RuntimeError, match="abstract"):
        outer.group("data")
