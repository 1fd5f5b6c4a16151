"""The sharded train step's compute split along ``model`` (Megatron
column- and row-parallel linears, the vocab-parallel cross entropy,
Megatron-SP), over gloo ranks on the CPU, held against JAX's
single-device ``train_step``.

One module fixture starts 2 ranks and 4 ranks at once
(``sharding.dist.launch``, each ``RANK_PROGRAM``) and meanwhile compiles
JAX's step for each config here.  Every case starts from JAX's init,
carried across by ``convert.params_from_jax``, with the step counter at
WARM (the full rate), and runs a direct sharded step on the first batch
(its loss and gathered gradients) and two ``train_step``s (the gathered
parameters after them):
- 2 ranks: danube masked 6:8 over (data 1, model 2), again with
  ``sequence_parallel`` and under two planted faults (``copy_in``
  without the all-reduce in its backward; a logsumexp over the rank's
  vocab slice only); granite-moe (MoE) and mamba2 (SSM, every ``wo``
  drawn) over (data 1, model 2);
- 4 ranks: danube over (data 2, model 2), and over (data 1, model 4),
  where its two KV heads split 2 ways and the axis holds two replicas.
Each rank also records the leaves ``M.loss_fn`` is given: its compute
shards.
"""
import dataclasses
import os
import pathlib
import sys
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import linear as jlin
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.runtime import steps as jsteps

from repro_torch import tree
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.core import linear as tlin
from repro_torch.models import transformer as ttrans
from repro_torch.sharding import dist as tdist, tp

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
DANUBE, GRANITE, MAMBA = ("h2o-danube-3-4b", "granite-moe-3b-a800m",
                          "mamba2-780m")
BATCH, SEQ, LR, WARM = 8, 32, 1e-3, 100
# test_torch_mesh_train.py's tolerances (JAX's own for a sharded step)
LOSS_RTOL, P_ATOL, P_RTOL = 2e-4, 5e-4, 2e-2
# gathered gradients, relative L2 over each leaf, fp32: the split sums
# each row-parallel output over the ranks and each column-parallel
# input's gradient, which reassociates; measured at most 8.6e-7 (danube),
# 7.8e-7 (granite) and 6.2e-6 (mamba2) against the port's one device
GRAD_RL2 = 1e-5
# the SSM's log-decay A_log and dt_bias: float32 loses digits in their
# gradients (sums of both signs through exp of segment sums): JAX's own
# A_log is 1.5e-5 off float64 (tests/test_torch_train_parity.py)
DECAY_GRAD_RL2 = 1e-4
DECAY = ("A_log", "dt_bias")
FAST_XLA = {"xla_backend_optimization_level": 0}
# JAX traces one step at a time (two threads tracing at once have
# crashed the interpreter); XLA compiles them in parallel
_TRACE = threading.Lock()
FAULTS = ("copy_in_no_sum", "local_lse")

# case -> (arch, (data, model), sequence_parallel, fault)
CASES = {
    "danube_1x2": (DANUBE, (1, 2), False, None),
    "danube_1x2_sp": (DANUBE, (1, 2), True, None),
    "danube_1x2_copy_in_no_sum": (DANUBE, (1, 2), False, "copy_in_no_sum"),
    "danube_1x2_local_lse": (DANUBE, (1, 2), False, "local_lse"),
    "granite_1x2": (GRANITE, (1, 2), False, None),
    "mamba2_1x2": (MAMBA, (1, 2), False, None),
    "danube_2x2": (DANUBE, (2, 2), False, None),
    "danube_1x4": (DANUBE, (1, 4), False, None),
}

RANK_PROGRAM = r'''
import dataclasses, sys
import torch
from repro_torch import tree
from repro_torch.configs import registry as treg
from repro_torch.core.linear import SparsityConfig
from repro_torch.models import model as TM, transformer
from repro_torch.optim import adamw
from repro_torch.runtime import steps, train_loop
from repro_torch.sharding import ctx, dist as rd, rules, tp

root = sys.argv[1]
rank, world = rd.init("gloo")
torch.set_num_threads(1)
inp = torch.load(f"{root}/inputs.pt", weights_only=False)
res = {}


def fault_on(fault):
    """Plant a fault; returns its undo."""
    if fault == "copy_in_no_sum":
        orig = tp._CopyIn.backward
        tp._CopyIn.backward = staticmethod(lambda c, g: (g, None))
        return lambda: setattr(tp._CopyIn, "backward", staticmethod(orig))
    if fault == "local_lse":
        orig = transformer._vocab_lse
        transformer._vocab_lse = lambda logits: torch.logsumexp(logits, -1)
        return lambda: setattr(transformer, "_vocab_lse", orig)
    return lambda: None


def run(name, arch, sizes, sp, fault):
    cfg = dataclasses.replace(
        treg.smoke_config(arch), sequence_parallel=sp,
        sparsity=SparsityConfig(pattern=(6, 8), mode="masked"))
    opt = adamw.AdamWConfig(lr=inp["lr"])
    mesh = ctx.Mesh(sizes, ("data", "model"), device="cpu")
    whole = tree.tree_map(lambda x: x.clone(), inp["p0"][arch])
    params, state, lay = train_loop._sharded_init(whole, opt, mesh)
    state = state._replace(step=torch.tensor(inp["warm"], dtype=torch.int32))
    batches = [{k: rules.cut(torch.from_numpy(v), rules.batch_spec(
        torch.from_numpy(v), mesh), mesh) for k, v in b.items()}
        for b in inp["batches"][arch]]
    seen = []
    orig_loss = steps.M.loss_fn

    def spy(p, c, b):
        seen.append([tuple(x.shape) for x in tree.leaves(p)])
        return orig_loss(p, c, b)

    undo = fault_on(fault)
    steps.M.loss_fn = spy
    try:
        ctx.reset_counts()
        loss, grads = steps.sharded_grads(cfg, params, batches[0], lay)
        kinds = ctx.collectives_by_kind()
        out = {"loss": float(loss), "kinds": kinds,
               "t": steps.split_degree(cfg, mesh),
               "grads": [rules.gather_leaf(g, s, mesh)
                         for g, s in zip(grads, lay.params)],
               "shards": seen[0]}
        if fault is None:
            for b in batches:
                params, state, _ = steps.train_step(cfg, opt, params, state,
                                                    b, layout=lay)
            out["params"] = rules.gather(params, lay.params, mesh)
            out["resident_ok"] = all(
                tuple(x.shape) == rules.local_shape(w.shape, s, mesh)
                for x, w, s in zip(tree.leaves(params),
                                   tree.leaves(out["params"]), lay.params))
    finally:
        steps.M.loss_fn = orig_loss
        undo()
    return out


for name, (arch, sizes, sp, fault) in inp["cases"].items():
    if sizes[0] * sizes[1] == world:
        res[name] = run(name, arch, sizes, sp, fault)
torch.save(res, f"{root}/rank{world}_{rank}.pt")
'''


def _cfgs(arch):
    sp = dict(pattern=(6, 8), mode="masked")
    return (dataclasses.replace(jreg.smoke_config(arch),
                                sparsity=jlin.SparsityConfig(**sp)),
            dataclasses.replace(treg.smoke_config(arch),
                                sparsity=tlin.SparsityConfig(**sp)))


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _draw_ssm_wo(p0, jcfg):
    """JAX's init zeroes every SSM block's ``wo`` (no gradient would reach
    the block's other weights); draw it."""
    if not jcfg.uses_ssm:
        return p0
    rng = np.random.default_rng(11)
    units = dict(p0["units"])
    for i, kind in enumerate(jcfg.unit_pattern):
        if kind == "ssm":
            lay = units[f"layer_{i}"]
            wo = np.asarray(lay["mixer"]["wo"]["w"])
            w = rng.standard_normal(wo.shape) * wo.shape[-1] ** -0.5
            units[f"layer_{i}"] = {**lay, "mixer": {
                **lay["mixer"], "wo": {"w": jnp.asarray(w, wo.dtype)}}}
    return {**p0, "units": units}


def _jax_init(arch):
    """JAX's init and two batches, as numpy."""
    jcfg, _ = _cfgs(arch)
    p0 = _draw_ssm_wo(jax.jit(JM.init, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)), jcfg)
    pipe = JSyntheticLM(jcfg, BATCH, SEQ, seed=0, host_index=0, host_count=1)
    return {"p0": _np(p0), "batches": [pipe.batch_at(s) for s in range(2)]}


def _jax_steps(arch, init):
    """JAX's jitted single-device step from the init at step counter
    WARM: the first step's loss and gradients (read off its first
    moment) and the params after both steps."""
    jcfg, _ = _cfgs(arch)
    opt = jadamw.AdamWConfig(lr=LR)
    with _TRACE:
        p0 = jax.tree_util.tree_map(jnp.asarray, init["p0"])
        batches = init["batches"]
        state = jadamw.init(p0, opt)._replace(
            step=jnp.asarray(WARM, jnp.int32))
        jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
        lowered = jax.jit(lambda p, o, b: jsteps.train_step(
            jcfg, opt, p, o, b)).lower(p0, state, jb[0])
    step = lowered.compile(compiler_options=FAST_XLA)
    params = p0
    for i, b in enumerate(jb):
        params, state, m = step(params, state, b)
        if i == 0:
            loss = float(m["loss"])
            clip = min(1.0, opt.grad_clip / max(float(m["grad_norm"]),
                                                1e-12))
            grads = jax.tree_util.tree_map(
                lambda a: np.asarray(a) / np.float32((1 - opt.b1) * clip),
                state.mu)
    return {"loss": loss, "grads": _np(grads), "params": _np(params)}


@pytest.fixture(scope="module")
def runs():
    """JAX's inits first; then the 2 and 4 ranks beside JAX's steps (XLA
    compiles outside the interpreter lock)."""
    tmp = tempfile.TemporaryDirectory(prefix="tp_train_")
    root = tmp.name
    archs = (DANUBE, GRANITE, MAMBA)
    inits = {a: _jax_init(a) for a in archs}
    port = {a: {"p0": params_from_jax(inits[a]["p0"], _cfgs(a)[1],
                                      device="cpu")} for a in archs}
    torch.save({"lr": LR, "warm": WARM, "cases": CASES,
                "p0": {a: port[a]["p0"] for a in archs},
                "batches": {a: inits[a]["batches"] for a in archs}},
               f"{root}/inputs.pt")
    cmd = [sys.executable, "-c", RANK_PROGRAM, root]
    with ThreadPoolExecutor(5) as ex:
        done = [ex.submit(tdist.launch, cmd, n, env=ENV, cwd=ROOT,
                          timeout=300) for n in (2, 4)]
        jx = {a: ex.submit(_jax_steps, a, inits[a]) for a in archs}
        jx = {a: f.result() for a, f in jx.items()}
        for f in done:
            f.result()
    for a in archs:
        port[a].update({k: params_from_jax(jx[a][k], _cfgs(a)[1],
                                           device="cpu")
                        for k in ("grads", "params")})
    ranks = {n: [torch.load(f"{root}/rank{n}_{r}.pt", weights_only=False)
                 for r in range(n)] for n in (2, 4)}
    tmp.cleanup()
    return {"ranks": ranks, "jax": jx, "port": port}


def _rl2(a, b) -> float:
    a = torch.as_tensor(np.asarray(a)).detach().to(torch.float64)
    b = torch.as_tensor(np.asarray(b)).detach().to(torch.float64)
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _case(runs, name):
    arch, sizes = CASES[name][:2]
    return runs["ranks"][sizes[0] * sizes[1]], arch


def _grad_misses(got, want):
    """The leaves whose gathered gradient lies past its tolerance, and
    the worst relative L2."""
    misses, worst = [], 0.0
    for path, a, b in zip(tree.paths(want), got, tree.leaves(want)):
        r = _rl2(a, b)
        worst = max(worst, r)
        if r > (DECAY_GRAD_RL2 if path[-1] in DECAY else GRAD_RL2):
            misses.append((path, r))
    return misses, worst


SOUND = [n for n, c in CASES.items() if c[3] is None]


@pytest.mark.parametrize("name", SOUND)
def test_split_step_equals_jax_single_device(runs, name):
    """Loss, gathered gradients and the params after two steps, on every
    rank, against JAX's jitted single-device step."""
    ranks, arch = _case(runs, name)
    want = runs["port"][arch]
    jloss = runs["jax"][arch]["loss"]
    for r in ranks:
        got = r[name]
        assert got["t"] == 2
        assert abs(got["loss"] - jloss) <= LOSS_RTOL * abs(jloss)
        misses, worst = _grad_misses(got["grads"], want["grads"])
        assert not misses, (name, misses)
        for path, a, b in zip(tree.paths(want["params"]),
                              tree.leaves(got["params"]),
                              tree.leaves(want["params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=P_ATOL,
                                       rtol=P_RTOL, err_msg=f"{name} {path}")
        assert got["resident_ok"]
    # the step moved the parameters by the full rate (not warmup's 0)
    moved = max(float((a - b).abs().max()) for a, b in zip(
        tree.leaves(ranks[0][name]["params"]),
        tree.leaves(want["p0"])))
    assert moved > 0.5 * LR


@pytest.mark.parametrize("name", SOUND)
def test_compute_shards_are_a_tth_of_each_role_leaf(runs, name):
    """``M.loss_fn`` gets, for every leaf the Megatron role table splits,
    1/t of it along that dim (t = 2 here), and every other leaf whole: no
    rank computes on whole copies of the split leaves."""
    ranks, arch = _case(runs, name)
    p0 = runs["port"][arch]["p0"]
    names = [[k for k in path if isinstance(k, str)]
             for path in tree.paths(p0)]
    split = 0
    for r in ranks:
        t = r[name]["t"]
        for nm, x, shape in zip(names, tree.leaves(p0), r[name]["shards"]):
            dim = tp.shard_dim(nm, x.dim())
            want = list(x.shape)
            if dim is not None:
                want[dim] //= t
                split += 1
            assert list(shape) == want, (name, nm, shape, want)
    assert split > 0
    roles = {nm[-2] for nm, x in zip(names, tree.leaves(p0))
             if tp.shard_dim(nm, x.dim()) is not None and nm[-1] == "w"}
    expect = {DANUBE: {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                       "lm_head"},
              GRANITE: {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                        "lm_head"},
              MAMBA: {"wx", "wz", "wdt", "wo", "lm_head"}}[arch]
    assert roles == expect


def test_sequence_parallel_equals_off(runs):
    """``sequence_parallel`` splits the residual stream along S (each
    row-parallel sum a reduce-scatter, each column group an all-gather):
    the same loss and gradients as without it, the same params after
    two steps."""
    ranks = runs["ranks"][2]
    for r in ranks:
        on, off = r["danube_1x2_sp"], r["danube_1x2"]
        assert "reduce-scatter" in on["kinds"]
        assert "reduce-scatter" not in off["kinds"]
        assert abs(on["loss"] - off["loss"]) <= 1e-6 * abs(off["loss"])
        assert max(_rl2(a, b) for a, b in zip(on["grads"], off["grads"])) \
            <= GRAD_RL2
        for a, b in zip(tree.leaves(on["params"]),
                        tree.leaves(off["params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                       rtol=1e-5)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_comparison(runs, fault):
    """A ``copy_in`` whose backward skips its all-reduce leaves each
    replicated leaf one rank's partial gradient; a logsumexp over the
    rank's own vocab slice moves the loss: both read far past the
    gradient tolerance."""
    want = runs["port"][DANUBE]["grads"]
    jloss = runs["jax"][DANUBE]["loss"]
    for r in runs["ranks"][2]:
        got = r[f"danube_1x2_{fault}"]
        _, worst = _grad_misses(got["grads"], want)
        assert worst > 10 * GRAD_RL2, (fault, worst)
        if fault == "local_lse":
            assert abs(got["loss"] - jloss) > LOSS_RTOL * abs(jloss)


def test_validate_refuses_a_masked_k_shard_straddling_groups():
    """Each rank STE-prunes its own K-slice of a row-parallel weight, so
    the slice must hold whole L-groups, or the shard's mask would not be
    the whole leaf's: d_ff 40 at 6:8 splits 2 ways into 20-wide slices."""
    cfg = dataclasses.replace(
        treg.smoke_config(DANUBE), d_ff=40,
        sparsity=tlin.SparsityConfig(pattern=(6, 8), mode="masked"))
    with pytest.raises(ValueError, match="w_down: K/tp=20"):
        tp.validate(cfg, 2)
    assert tp.degree(cfg, 2) == 1
    dense = dataclasses.replace(cfg, sparsity=tlin.SparsityConfig())
    tp.validate(dense, 2)
    assert tp.degree(dense, 2) == 2
    ok = dataclasses.replace(cfg, d_ff=96)
    assert tp.degree(ok, 2) == 2 and tp.degree(ok, 4) == 2


def test_remat_recompute_runs_under_the_forward_context():
    """A checkpointed forward runs again in the backward, which autograd
    may run on another thread (its device threads): the recompute sees
    the context of the forward, not the thread's."""
    import threading
    x = torch.randn(4, 6, requires_grad=True)

    def fn(a):
        return (a.reshape(tp.size(), -1) ** 2).sum(0)

    with tp.activate_dry(2):
        y = ttrans.remat(fn, x)
    out = {}

    def back():
        out["g"] = torch.autograd.grad(y.sum(), x)[0]

    th = threading.Thread(target=back)
    th.start()
    th.join()
    assert torch.allclose(out["g"], 2 * x.detach())
