"""The sequence-sharded serve step (``steps.serve_step(mesh=...)``,
``steps.decode``) over four gloo ranks on the CPU, held against JAX's
single-device ``steps.serve_step`` on the same whole cache.

One module fixture draws JAX's init for each config (smoke widths, fp32,
6:8 ``compressed``, recipe none, window 20; every SSM ``wo`` drawn),
packs it for both, draws every whole cache with numpy from a seed, and
starts one 4-rank job over (data 2, model 2) (``sharding.dist.launch``,
``RANK_PROGRAM``) beside JAX's jitted steps in threads.  Each rank
shards the weights by the serving tensor parallelism, cuts its piece of
the cache (``rules.cut_cache``: S over (data, model) at batch 1, B over
data and S over model at batch 2), greedy-decodes four tokens and
gathers the cache back; JAX decodes the same four from the same cache.

Tolerances, fp32: the logits of each step within relative L2 LOGIT_RL2
of JAX's (the combine reassociates the softmax sums, the row-parallel
projections sum their partials over the ranks; measured at most 9.3e-7
for danube, 2.2e-6 gemma3, 2.6e-6 jamba), the greedy tokens identical,
the gathered cache's float leaves within CACHE_ATOL of JAX's (at most
7.0e-6, jamba's SSM state) and its int8 leaves within one step (read
equal).  Three planted faults must each fail the comparison: the
combine without the exp(m_i - M) rescale, shard 0's partials left out,
and the new token written at its global index (clamped) on every rank
(read 0.87, 1.42 and 0.98).  JAX's
``NamedSharding`` of a cache leaf on four host devices (a child
process) fixes the order of the S-shards: the first axis named is the
major one.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import linear as jlin
from repro.models import model as JM
from repro.runtime import serve_loop as jserve, steps as jsteps

from repro_torch import tree
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import linear as tlin
from repro_torch.models import model as TM
from repro_torch.runtime import serve_loop as tserve, steps as tsteps
from repro_torch.sharding import ctx, dist as tdist, rules

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
DANUBE, GEMMA, JAMBA, MAMBA = ("h2o-danube-3-4b", "gemma3-12b",
                               "jamba-1.5-large-398b", "mamba2-780m")
S, NEW, WINDOW, SIZES = 64, 4, 20, (2, 2)
LOGIT_RL2, CACHE_ATOL = 1e-5, 1e-5
FAST_XLA = {"xla_backend_optimization_level": 0}
FAULTS = ("no_rescale", "drop_shard", "global_write")

# case -> (arch, batch, kv_len of the first token, KV cache dtype); S is
# 64, 16 a shard at batch 1.  danube's window of 20: "mid" writes inside
# shard 0 and its window lies there (shards 1-3 hold no valid position);
# "boundary" writes the last position of shard 1, then shard 2's first;
# "straddle" attends over shards 0 and 1
CASES = {
    "danube_mid": (DANUBE, 1, 8, "float32"),
    "danube_boundary": (DANUBE, 1, 31, "float32"),
    "danube_straddle": (DANUBE, 1, 20, "float32"),
    "danube_b2": (DANUBE, 2, 40, "float32"),
    "danube_int8kv": (DANUBE, 1, 29, "int8"),
    "gemma3": (GEMMA, 1, 37, "float32"),
    "jamba": (JAMBA, 1, 45, "float32"),
    "mamba2": (MAMBA, 1, 10, "float32"),
}
FAULT_CASE = "danube_straddle"

RANK_PROGRAM = r'''
import dataclasses, sys
import torch
from repro_torch import tree
from repro_torch.configs import registry as treg
from repro_torch.core.linear import SparsityConfig
from repro_torch.models import attention
from repro_torch.runtime import steps
from repro_torch.sharding import ctx, dist as rd, rules, seq

root = sys.argv[1]
rank, world = rd.init("gloo")
torch.set_num_threads(1)
inp = torch.load(f"{root}/inputs.pt", weights_only=False)
mesh = ctx.Mesh(inp["sizes"], ("data", "model"), device="cpu")


def fault_on(fault):
    """Plant a fault; returns its undo."""
    if fault == "no_rescale":
        orig = seq.merge
        seq.merge = lambda parts: parts[..., :-2].sum(0) \
            / parts[..., -2].sum(0)[..., None]
        return lambda: setattr(seq, "merge", orig)
    if fault == "drop_shard":
        orig = seq.merge
        seq.merge = lambda parts: orig(parts[1:])
        return lambda: setattr(seq, "merge", orig)
    if fault == "global_write":
        orig = attention._write_slot
        attention._write_slot = lambda kv_len, shard: (
            torch.clamp(kv_len[:1].long(), 0, shard.length - 1),
            torch.ones(1, dtype=torch.bool))
        return lambda: setattr(attention, "_write_slot", orig)
    return lambda: None


def run(name, fault=None):
    arch, b, kv0, kvd = inp["cases"][name]
    cfg = dataclasses.replace(
        treg.smoke_config(arch), sliding_window=inp["window"],
        kv_cache_dtype=kvd, sparsity=SparsityConfig(
            pattern=(6, 8), mode="compressed"))
    params = steps.serve_params(inp["params"][(arch, kvd)], cfg, mesh)
    cache, lay = rules.cut_cache(inp["caches"][name], mesh,
                                 steps.serve_axis(cfg, mesh))
    rows = tree.leaves(cache)[0].shape[0]
    lo = rules.offset(lay.specs[0], 0, b, mesh) if lay.specs[0] else 0
    token, kv_len = inp["token"][name], inp["kv_len"][name]
    undo = fault_on(fault)
    try:
        ctx.reset_counts()
        toks, logits, cache, _ = steps.decode(
            cfg, params, token[lo:lo + rows], cache, kv_len[lo:lo + rows],
            inp["new"], mesh=mesh, layout=lay)
        count = ctx.collective_count()
    finally:
        undo()
    out = {"rows": (lo, lo + rows), "tokens": toks, "logits": logits,
           "collectives": count,
           "seq": None if lay.seq is None else
           (lay.seq.axes, lay.seq.offset, lay.seq.length),
           "piece": [tuple(x.shape) for x in tree.leaves(cache)]}
    whole = rules.gather(cache, lay.specs, mesh)
    if rank == 0:
        out["cache"] = whole
    return out


res = {name: run(name) for name in inp["cases"]}
for f in inp["faults"]:
    res[f"fault_{f}"] = run(inp["fault_case"], f)
torch.save(res, f"{root}/rank{rank}.pt")
'''

# JAX's NamedSharding of an attention cache leaf on a (data 2, model 2)
# mesh of four host devices: each mesh position's B and S slices
ORDER_PROGRAM = r'''
import json
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.tree_util import DictKey
from repro.sharding import rules
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for b in (1, 2):
    leaf = jax.ShapeDtypeStruct((2, b, 64, 2, 16), jnp.float32)
    spec = rules.cache_spec((DictKey("layer_0"), DictKey("k")), leaf, mesh)
    idx = NamedSharding(mesh, spec).devices_indices_map(leaf.shape)
    out[b] = [[[idx[mesh.devices[d, m]][i].indices(leaf.shape[i])[:2]
                for i in (1, 2)] for m in range(2)] for d in range(2)]
print(json.dumps(out))
'''


def _cfgs(arch, kvd):
    sp = dict(pattern=(6, 8), mode="compressed")
    over = dict(sliding_window=WINDOW, kv_cache_dtype=kvd)
    return (dataclasses.replace(jreg.smoke_config(arch), **over,
                                sparsity=jlin.SparsityConfig(
                                    use_pallas=False, **sp)),
            dataclasses.replace(treg.smoke_config(arch), **over,
                                sparsity=tlin.SparsityConfig(**sp)))


def _jax_init(arch):
    """JAX's init as numpy, every SSM block's ``wo`` drawn (init zeroes
    it, which makes the block the identity)."""
    jcfg, _ = _cfgs(arch, "float32")
    p0 = jax.tree_util.tree_map(np.asarray, jax.jit(
        JM.init, static_argnums=0)(jcfg, jax.random.PRNGKey(0)))
    if not jcfg.uses_ssm:
        return p0
    rng = np.random.default_rng(11)
    units = dict(p0["units"])
    for i, kind in enumerate(jcfg.unit_pattern):
        if kind == "ssm":
            lay = units[f"layer_{i}"]
            wo = lay["mixer"]["wo"]["w"]
            w = rng.standard_normal(wo.shape) * wo.shape[-1] ** -0.5
            units[f"layer_{i}"] = {**lay, "mixer": {
                **lay["mixer"], "wo": {"w": w.astype(wo.dtype)}}}
    return {**p0, "units": units}


def _draw_cache(jcfg, b, seed):
    """A whole one-shot cache in JAX's stacked layout, as numpy: K/V and
    SSM state N(0, 1), int8 K/V uniform on [-127, 127] with scales on
    [0.002, 0.03]."""
    rng = np.random.default_rng(seed)

    def draw(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return rng.integers(-127, 128, a.shape).astype(np.int8)
        if a.shape[-1] == 1:
            return rng.uniform(0.002, 0.03, a.shape).astype(a.dtype)
        return rng.standard_normal(a.shape).astype(a.dtype)
    return jax.tree_util.tree_map(draw, JM.make_cache(jcfg, b, S))


def _port_cache(jcache, units):
    """JAX's stacked cache -> the port's list of unit dicts."""
    return [jax.tree_util.tree_map(lambda a, u=u: to_torch(a[u], "cpu"),
                                   jcache) for u in range(units)]


def _jax_decode(jcfg, packed, jcache, token, kv_len):
    """NEW greedy steps of JAX's jitted single-device serve step."""
    p = jax.tree_util.tree_map(jnp.asarray, packed)
    cache = jax.tree_util.tree_map(jnp.asarray, jcache)
    tok, kv = jnp.asarray(token), jnp.asarray(kv_len)
    step = jax.jit(lambda p, t, c, k: jsteps.serve_step(jcfg, p, t, c, k)) \
        .lower(p, tok, cache, kv).compile(compiler_options=FAST_XLA)
    toks, logits = [], []
    for _ in range(NEW):
        lg, cache, kv = step(p, tok, cache, kv)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits.append(np.asarray(lg))
    return {"tokens": np.stack(toks, 1), "logits": np.stack(logits, 1),
            "cache": jax.tree_util.tree_map(np.asarray, cache)}


def _jax_order():
    env = {**ENV, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    out = subprocess.run([sys.executable, "-c", ORDER_PROGRAM], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    return {int(k): v for k, v in json.loads(out.stdout).items()}


@pytest.fixture(scope="module")
def runs():
    """JAX's inits and the caches first; then the four ranks beside
    JAX's packing and steps (XLA compiles outside the interpreter lock)
    and the ordering child."""
    tmp = tempfile.TemporaryDirectory(prefix="seq_serve_")
    root = tmp.name
    keys = sorted({(c[0], c[3]) for c in CASES.values()})
    inits = {a: _jax_init(a) for a in sorted({k[0] for k in keys})}
    port = {(a, kvd): tserve.pack_params(params_from_jax(
        inits[a], _cfgs(a, kvd)[1], device="cpu"), _cfgs(a, kvd)[1])
        for a, kvd in keys}
    jcaches, token, kv_len = {}, {}, {}
    for i, (name, (arch, b, kv0, kvd)) in enumerate(CASES.items()):
        jcfg = _cfgs(arch, kvd)[0]
        jcaches[name] = _draw_cache(jcfg, b, 100 + i)
        rng = np.random.default_rng(200 + i)
        token[name] = rng.integers(0, jcfg.vocab_size, (b,)).astype(np.int32)
        kv_len[name] = np.full((b,), kv0, np.int32)
    torch.save({"sizes": SIZES, "S": S, "new": NEW, "window": WINDOW,
                "cases": CASES, "params": port, "faults": FAULTS,
                "fault_case": FAULT_CASE,
                "caches": {n: _port_cache(c, _cfgs(CASES[n][0],
                                                   CASES[n][3])[1].num_units)
                           for n, c in jcaches.items()},
                "token": {n: torch.from_numpy(t) for n, t in token.items()},
                "kv_len": {n: torch.from_numpy(k) for n, k in kv_len.items()}},
               f"{root}/inputs.pt")
    cmd = [sys.executable, "-c", RANK_PROGRAM, root]
    with ThreadPoolExecutor(4) as ex:
        ranks = ex.submit(tdist.launch, cmd, 4, env=ENV, cwd=ROOT,
                          timeout=300)
        order = ex.submit(_jax_order)
        packed = {k: ex.submit(jserve.pack_params, inits[k[0]],
                               _cfgs(*k)[0]) for k in keys}
        packed = {k: f.result() for k, f in packed.items()}
        jx = {n: ex.submit(_jax_decode, _cfgs(c[0], c[3])[0],
                           packed[(c[0], c[3])], jcaches[n], token[n],
                           kv_len[n]) for n, c in CASES.items()}
        jx = {n: f.result() for n, f in jx.items()}
        order = order.result()
        ranks.result()
    got = [torch.load(f"{root}/rank{r}.pt", weights_only=False)
           for r in range(4)]
    tmp.cleanup()
    return {"ranks": got, "jax": jx, "order": order}


def _rl2(a, b) -> float:
    a = torch.as_tensor(np.asarray(a)).to(torch.float64)
    b = torch.as_tensor(np.asarray(b)).to(torch.float64)
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _worst_logits(got, want) -> float:
    """The worst step's relative L2 of a rank's logits rows [b, NEW, V]
    against JAX's."""
    lo, hi = got["rows"]
    return max(_rl2(got["logits"][:, i], want["logits"][lo:hi, i])
               for i in range(NEW))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_equals_jax_single_device(runs, name):
    """Every rank's greedy tokens equal JAX's, its logits within
    LOGIT_RL2 at each of the four steps."""
    want = runs["jax"][name]
    for r in runs["ranks"]:
        got = r[name]
        lo, hi = got["rows"]
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      want["tokens"][lo:hi])
        assert _worst_logits(got, want) <= LOGIT_RL2, name


@pytest.mark.parametrize("name", list(CASES))
def test_gathered_cache_equals_jax(runs, name):
    """The pieces gathered back after four steps: JAX's updated cache,
    the four new tokens' K/V (and int8 scales) written in place, every
    other position untouched; SSM state within the same tolerance."""
    arch, _, _, kvd = CASES[name]
    got = runs["ranks"][0][name]["cache"]
    want = _port_cache(runs["jax"][name]["cache"],
                       _cfgs(arch, kvd)[1].num_units)
    for path, a, b in zip(tree.paths(want), tree.leaves(got),
                          tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.dtype == torch.int8:
            assert int((a.int() - b.int()).abs().max()) <= 1, path
        else:
            assert float((a - b).abs().max()) <= CACHE_ATOL, path


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_piece_only(runs, name):
    """A rank's cache piece: S / 4 of each attention leaf at batch 1
    (S over data and model, the first axis the major one), B / 2 and
    S / 2 at batch 2; SSM state at half its heads / d_inner (the
    serving tensor parallelism, t = 2)."""
    arch, b, _, kvd = CASES[name]
    whole = TM.make_cache(_cfgs(arch, kvd)[1], b, S, device="meta")
    for rank, r in enumerate(runs["ranks"]):
        got = r[name]
        d, m = divmod(rank, 2)
        for names, x, shape in zip(tree.paths(whole), tree.leaves(whole),
                                   got["piece"]):
            want = list(x.shape)
            if names[-1] in rules.ATTN_CACHE:
                if b == 1:
                    want[1] //= 4
                else:
                    want[0] //= 2
                    want[1] //= 2
            else:
                want[rules.SSM_CACHE_DIM[names[-1]]] //= 2
            assert list(shape) == want, (name, names, shape)
        if got["seq"] is not None:
            axes, off, length = got["seq"]
            n = 4 if b == 1 else 2
            idx = d * 2 + m if b == 1 else m
            assert (axes, off, length) == (
                ("data", "model") if b == 1 else ("model",),
                idx * S // n, S // n)
        else:
            assert arch == MAMBA


def test_s_shard_order_is_jax_named_sharding(runs):
    """JAX's ``NamedSharding`` of ``cache_spec``'s spec on four host
    devices gives each mesh position (data d, model m) the B and S
    slices the port's layout gives rank 2d + m, at batch 1 (S over
    (data, model): shard d * 2 + m) and at batch 2."""
    for b in (1, 2):
        whole = [{"layer_0": {"k": torch.empty((b, S, 2, 16),
                                               device="meta")}}] * 2
        for d in range(2):
            for m in range(2):
                mesh = ctx.Mesh.abstract({"data": 2, "model": 2},
                                         rank=d * 2 + m)
                lay = rules.serve_cache_layout(whole, mesh)
                spec = lay.specs[0]
                bs = rules.offset(spec, 0, b, mesh)
                nb = rules.local_shape((b,), spec[:1], mesh)[0]
                off, length = lay.seq.offset, lay.seq.length
                assert [[bs, bs + nb], [off, off + length]] == \
                    runs["order"][b][d][m], (b, d, m)


def test_collectives_a_step(runs):
    """Per step and layer: one gather of the new q/k/v heads, one gather
    of the partials per S axis, the two row-parallel all-reduces; then
    one gather of the logits, whose argmax gives the greedy ids.  The
    same count on every rank."""
    per_step = {"danube_mid": 2 * 5 + 1, "danube_b2": 2 * 4 + 1}
    for name, want in per_step.items():
        counts = {r[name]["collectives"] for r in runs["ranks"]}
        assert counts == {NEW * want}, (name, counts)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_comparison(runs, fault):
    """The combine without the exp(m_i - M) rescale, shard 0's partials
    left out, and the new token written at its global index on every
    rank each move the logits far past LOGIT_RL2, while the sound run of
    the same case stays within it."""
    want = runs["jax"][FAULT_CASE]
    for r in runs["ranks"]:
        assert _worst_logits(r[FAULT_CASE], want) <= LOGIT_RL2
        assert _worst_logits(r[f"fault_{fault}"], want) > 100 * LOGIT_RL2


def test_mesh_needs_the_cache_layout():
    """A serve step over a mesh without the cache's layout raises; the
    sequence-sharded step refuses an encoder-decoder."""
    cfg = treg.smoke_config(DANUBE)
    mesh = ctx.Mesh.abstract({"data": 1, "model": 1})
    with pytest.raises(ValueError, match="layout"):
        tsteps.serve_step(cfg, {}, None, None, None, mesh=mesh)
    with pytest.raises(ValueError, match="decoder-only"):
        tsteps.serve_axis(treg.smoke_config("whisper-small"), mesh)
