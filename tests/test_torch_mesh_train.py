"""Multi-device training over gloo ranks on the CPU: the sharded step,
``train(mesh=...)``, GPipe, int8 cross-pod compression and elastic
restore, held against the port's single-device path and the JAX
package's single-device step and sequential references.

One module fixture starts 8 ranks once (``sharding.dist.launch``, each
``RANK_PROGRAM``), then 4 ranks; meanwhile it computes the references
here.  The 8 ranks run:
- granite-moe smoke at JAX's test shapes (global batch 8 x 32, lr 1e-3)
  on (pod 2, data 2, model 2): ``train(mesh=...)`` for 3 steps, again as
  2 steps and a resume to 3 through a checkpoint; then one sharded step
  from the same init with the step counter at 100 (so the rate is the
  full 1e-3, not warmup's 0) on a batch whose labels are -1 unevenly
  across the data-parallel slices: its loss, its gathered gradients and
  the parameters after it, sound and under two planted faults (one rank
  skips the data-parallel gradient sum; the loss is the mean of the
  local means);
- danube smoke, masked 6:8, int8 AdamW moments, two sharded steps;
- granite at capacity factor 1.25, which the MoE group rule refuses;
- GPipe on (data 2, stage 4) at JAX's test shapes;
- the cross-pod compression on (pod 2, data 2, model 2);
- minitron smoke cut for (data 4, model 2) and checkpointed.
The 4 ranks restore that checkpoint onto ``elastic_mesh`` (data 2,
model 2), and a single-device checkpoint onto the same mesh.
"""
import dataclasses
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
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import adamw as jadamw
from repro.runtime import compression as jcomp
from repro.runtime import steps as jsteps

from repro_torch import tree
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import registry as treg
from repro_torch.core import linear as tlin
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw, schedule as tschedule
from repro_torch.runtime import steps as tsteps, train_loop
from repro_torch.sharding import dist as tdist

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
GRANITE, DANUBE, MINITRON = ("granite-moe-3b-a800m", "h2o-danube-3-4b",
                             "minitron-4b")
BATCH, SEQ, STEPS, LR = 8, 32, 3, 1e-3
WARM = 100          # the step counter of the direct steps: rate scale 1
# JAX's own tolerances for a sharded step (test_distributed.py)
LOSS_RTOL, P_ATOL, P_RTOL = 2e-4, 5e-4, 2e-2
# gathered gradients vs the single-device step, relative L2 over the
# leaf, fp32 on the CPU: the sharded sums reassociate (measured at most
# 1.1e-6 on granite, against the port's and JAX's); the planted faults
# read 0.71 and 1.72
GRAD_RL2 = 1e-5
# danube's int8 moments (dequantized) after two steps, against the
# single-device update of the same gradients: measured 4.5e-7 (every int8
# value equal); a one-ulp change of a gradient can move a block's absmax,
# and so every int8 step of the block, by one part in 127
STATE_RL2 = 1e-4
FAST_XLA = {"xla_backend_optimization_level": 0}

RANK_PROGRAM = r'''
import dataclasses, sys
import numpy as np, torch
from repro_torch import tree
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import registry as treg
from repro_torch.core.linear import SparsityConfig
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.launch import mesh as launch_mesh
from repro_torch.runtime import compression, elastic, pipeline, steps
from repro_torch.runtime import train_loop
from repro_torch.sharding import ctx, dist as rd, rules

root = sys.argv[1]
rank, world = rd.init("gloo")
torch.set_num_threads(1)
inp = torch.load(f"{root}/inputs.pt", weights_only=False)
res = {}


def whole_init(cfg):
    return TM.init(cfg, torch.Generator().manual_seed(0))


def local(batch, mesh):
    return {k: rules.cut(v, rules.batch_spec(v, mesh), mesh)
            for k, v in batch.items()}


def direct(cfg, opt, mesh, batches, fault=None):
    """Sharded steps from the seed-0 init with the step counter at WARM:
    the first step's loss and gathered grads, the final gathered state."""
    params, state, lay = train_loop._sharded_init(whole_init(cfg), opt, mesh)
    state = state._replace(step=torch.tensor(inp["warm"], dtype=torch.int32))
    orig_rg, orig_w = steps.reduce_grad, steps.loss_weight
    if fault == "skip_dp_sum":
        def faulty(g, spec, mesh):
            out = orig_rg(g, spec, mesh)  # the collectives still run
            if mesh.rank == 1:            # ... but rank 1 keeps its own
                dp = mesh.axis_size("pod") * mesh.axis_size("data")
                return rules.cut(g.float(), spec, mesh) * dp
            return out
        steps.reduce_grad = faulty
    if fault == "mean_of_means":
        steps.loss_weight = lambda count, total: torch.tensor(
            1.0 / (mesh.axis_size("pod") * mesh.axis_size("data")))
    orig_sg = steps.sharded_grads
    step_grads = []

    def recorded(*a, **kw):
        loss, grads = orig_sg(*a, **kw)
        step_grads.append([rules.gather_leaf(g, s, mesh)
                           for g, s in zip(grads, lay.params)])
        return loss, grads

    try:
        out = {}
        for i, b in enumerate(batches):
            lb = local(b, mesh)
            if i == 0:
                loss, grads = steps.sharded_grads(cfg, params, lb, lay)
                out["loss"] = float(loss)
                out["grads"] = [rules.gather_leaf(g, s, mesh)
                                for g, s in zip(grads, lay.params)]
            steps.sharded_grads = recorded
            params, state, m = steps.train_step(cfg, opt, params, state, lb,
                                                layout=lay)
            steps.sharded_grads = orig_sg
        out["step_grads"] = step_grads
        out["params"] = rules.gather(params, lay.params, mesh)
        out["state"] = rules.gather(state, lay.opt, mesh)
        out["resident"] = rules.resident_bytes(params) + \
            rules.resident_bytes(state)
        out["local_ok"] = all(
            tuple(x.shape) == rules.local_shape(w.shape, s, mesh)
            for x, w, s in zip(tree.leaves(params) + tree.leaves(state),
                               tree.leaves(out["params"])
                               + tree.leaves(out["state"]),
                               lay.params + lay.opt))
        return out
    finally:
        steps.reduce_grad, steps.loss_weight = orig_rg, orig_w
        steps.sharded_grads = orig_sg


if world == 8:
    mesh = ctx.Mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    cfg = treg.smoke_config("granite-moe-3b-a800m")
    opt = adamw.AdamWConfig(lr=inp["lr"])
    tc = train_loop.TrainConfig(steps=inp["steps"], global_batch=inp["batch"],
                                seq_len=inp["seq"], seed=0, log_every=0)
    ctx.reset_counts()
    run = train_loop.train(cfg, opt, tc, mesh=mesh)
    lay = run["layout"]
    res["train"] = {"losses": run["losses"],
                    "collectives": ctx.collective_count() / inp["steps"],
                    "params": rules.gather(run["params"], lay.params, mesh)}
    res["resident"] = (rules.resident_bytes(run["params"])
                       + rules.resident_bytes(run["opt_state"]))
    res["logical"] = sum(
        int(np.prod(rules.global_shape(x.shape, s, mesh))) * x.element_size()
        for x, s in zip(tree.leaves({"params": run["params"],
                                     "opt": run["opt_state"]}), lay.state))
    d = f"{root}/granite_ckpt"
    train_loop.train(cfg, opt, dataclasses.replace(
        tc, steps=inp["steps"] - 1, ckpt_dir=d, ckpt_every=1), mesh=mesh)
    again = train_loop.train(cfg, opt, dataclasses.replace(
        tc, ckpt_dir=d, ckpt_every=1), mesh=mesh)
    res["resumed"] = {"losses": again["losses"], "params": rules.gather(
        again["params"], lay.params, mesh)}
    batch = {k: torch.from_numpy(v) for k, v in inp["granite_batch"].items()}
    for fault in (None, "skip_dp_sum", "mean_of_means"):
        res[f"direct_{fault}"] = direct(cfg, opt, mesh, [batch], fault)

    dcfg = dataclasses.replace(
        treg.smoke_config("h2o-danube-3-4b"),
        sparsity=SparsityConfig(pattern=(6, 8), mode="masked"))
    res["danube_int8"] = direct(
        dcfg, adamw.AdamWConfig(lr=3e-3, state_dtype="int8"), mesh,
        [{k: torch.from_numpy(v) for k, v in b.items()}
         for b in inp["danube_batches"]])

    mcfg = dataclasses.replace(cfg, moe_capacity_factor=1.25)
    p, s, mlay = train_loop._sharded_init(whole_init(mcfg), opt, mesh)
    try:
        steps.sharded_grads(mcfg, p, local(batch, mesh), mlay)
        res["moe_refused"] = None
    except ValueError as e:
        res["moe_refused"] = str(e)

    pmesh = ctx.Mesh((2, 4), ("data", "stage"), device="cpu")
    piece = rules.shard(torch.from_numpy(inp["ws"]), [("stage",)], pmesh)
    piece.requires_grad_(True)
    x = torch.from_numpy(inp["x"])
    out = pipeline.gpipe_apply(lambda w, h: torch.tanh(h @ w), piece, x,
                               mesh=pmesh, axis="stage", microbatches=4)
    (out ** 2).sum().backward()
    res["gpipe"] = {"out": out.detach(),
                    "grads": pmesh.all_gather(piece.grad, "stage", 0)}

    g = torch.from_numpy(inp["g"])
    e0 = torch.zeros_like(g)
    mean, err = compression.compressed_crosspod_mean(g, e0, mesh)
    mean2, err2 = compression.compressed_crosspod_mean(g, err, mesh)
    rmean, rerr = compression.compressed_crosspod_mean(
        torch.from_numpy(inp["g_pod"][0]), torch.from_numpy(inp["e_pod"][0]),
        mesh)
    gp = torch.from_numpy(inp["g_pod"][mesh.coord("pod")])
    ctx.reset_counts()
    pm, pe = compression.compressed_crosspod_mean(
        gp, torch.from_numpy(inp["e_pod"][mesh.coord("pod")]), mesh)
    wire = ctx.wire_bytes()
    same, _ = compression.compressed_crosspod_mean(
        g, e0, launch_mesh.make_host_mesh(device="cpu"))
    tm, te = compression.tree_compressed_crosspod_mean(
        {"a": g, "b": [gp]}, {"a": e0, "b": [torch.from_numpy(
            inp["e_pod"][mesh.coord("pod")])]}, mesh)
    res["compression"] = {"mean": mean, "err": err, "mean2": mean2,
                          "err2": err2, "rmean": rmean, "rerr": rerr,
                          "pod_mean": pm, "pod_err": pe,
                          "wire": wire, "no_pod_is_identity": same is g,
                          "tree": [tm["a"], tm["b"][0], te["a"], te["b"][0]]}
    try:
        launch_mesh.make_production_mesh(device="cpu")
        res["production"] = None
    except ValueError as e:
        res["production"] = str(e)

    emesh = ctx.Mesh((4, 2), ("data", "model"), device="cpu")
    mini = whole_init(treg.smoke_config("minitron-4b"))
    pieces = elastic.reshard(mini, emesh)
    ckpt.save(f"{root}/elastic", 3, pieces,
              specs=rules.params_shardings(mini, emesh), mesh=emesh)
    res["elastic_mesh"] = elastic.elastic_mesh(prefer_model=16,
                                               device="cpu").shape
else:
    m4 = elastic.elastic_mesh(prefer_model=2, device="cpu")
    mini = whole_init(treg.smoke_config("minitron-4b"))
    specs = rules.params_shardings(mini, m4)
    want = rules.shard(mini, specs, m4)
    restored, step, _ = ckpt.restore(f"{root}/elastic", mini, device="cpu")
    pieces = elastic.reshard(restored, m4)
    direct_ = ckpt.restore(f"{root}/elastic", want, specs=specs, mesh=m4)[0]
    single = ckpt.restore(f"{root}/single", want, specs=specs, mesh=m4)[0]
    res["elastic"] = {
        "shape": m4.shape, "step": step,
        "reshard": [torch.equal(a, b) for a, b in
                    zip(tree.leaves(pieces), tree.leaves(want))],
        "restore": [torch.equal(a, b) for a, b in
                    zip(tree.leaves(direct_), tree.leaves(want))],
        "single": [torch.equal(a, rules.cut(b + 1, s, m4)) for a, b, s in
                   zip(tree.leaves(single), tree.leaves(mini), specs)],
        "gather": [torch.equal(a, b) for a, b in zip(
            tree.leaves(rules.gather(pieces, specs, m4)), tree.leaves(mini))],
        "sharded": any(a.numel() < b.numel() for a, b in
                       zip(tree.leaves(pieces), tree.leaves(mini)))}
torch.save(res, f"{root}/rank{rank}.pt")
'''


def _rl2(a, b) -> float:
    a = torch.as_tensor(np.asarray(a)).detach().to(torch.float64)
    b = torch.as_tensor(np.asarray(b)).detach().to(torch.float64)
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _jax_tree(tp):
    """The port's params (unit lists) as JAX's stacked numpy tree."""
    def np_tree(node):
        if isinstance(node, dict):
            return {k: np_tree(v) for k, v in node.items()}
        return node.detach().numpy()

    out = {}
    for k, v in tp.items():
        if isinstance(v, list):
            out[k] = jax.tree_util.tree_map(lambda *xs: np.stack(xs),
                                            *[np_tree(u) for u in v])
        else:
            out[k] = np_tree(v)
    return out


def _unit_leaves(jtree, tp):
    """JAX's stacked leaves in the port's order (sliced per unit)."""
    flat = []
    for path in tree.paths(tp):
        node = jtree
        unit = None
        for k in path:
            if isinstance(k, int):
                unit = k
            else:
                node = node[k]
        flat.append(np.asarray(node) if unit is None
                    else np.asarray(node)[unit])
    return flat


def _granite_batch():
    """A global batch whose -1 labels fall unevenly on the data-parallel
    slices (2 rows each): all of row 0, most of row 1, a few elsewhere."""
    b = SyntheticLM(treg.smoke_config(GRANITE), BATCH, SEQ, seed=0,
                    host_index=0, host_count=1).batch_at(5)
    labels = b["labels"].copy()
    labels[0, :] = -1
    labels[1, 4:] = -1
    labels[5, :3] = -1
    return {"tokens": b["tokens"], "labels": labels}


def _jax_granite(tp0, batches, gbatch):
    """JAX's jitted single-device step on the port's init: STEPS steps on
    the pipeline's batches, and one step at step counter WARM on the -1
    batch (its loss, grads read off the first moment, params)."""
    jcfg = jreg.smoke_config(GRANITE)
    opt = jadamw.AdamWConfig(lr=LR)
    p0 = _jax_tree(tp0)
    state = jadamw.init(p0, opt)
    step = jax.jit(lambda p, o, b: jsteps.train_step(jcfg, opt, p, o, b)) \
        .lower(p0, state, {k: jnp.asarray(v) for k, v in batches[0].items()}
               ).compile(compiler_options=FAST_XLA)
    params, losses = p0, []
    for b in batches:
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    out = {"losses": losses, "params": params}
    st = jadamw.init(p0, opt)._replace(step=jnp.asarray(WARM, jnp.int32))
    wp, ws, m = step(p0, st, {k: jnp.asarray(v) for k, v in gbatch.items()})
    clip = min(1.0, opt.grad_clip / max(float(m["grad_norm"]), 1e-12))
    out["direct"] = {
        "loss": float(m["loss"]), "params": wp,
        "grads": jax.tree_util.tree_map(
            lambda a: np.asarray(a) / np.float32((1 - opt.b1) * clip), ws.mu)}
    return out


def _port_direct(cfg, opt, batches):
    """The port's single-device steps from the seed-0 init at WARM."""
    params = TM.init(cfg, torch.Generator().manual_seed(0))
    state = tadamw.init(params, opt)._replace(
        step=torch.tensor(WARM, dtype=torch.int32))
    out = {"step_grads": []}
    for i, b in enumerate(batches):
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        leaves = tsteps.trainable(params)
        loss = TM.loss_fn(params, cfg, b)
        grads = torch.autograd.grad(loss, leaves)
        if i == 0:
            out["loss"] = float(loss.detach())
            out["grads"] = grads
        out["step_grads"].append(grads)
        params, state, _ = tsteps.train_step(cfg, opt, params, state, b)
    out.update(params=params, state=state)
    return out


def _jax_gpipe():
    """JAX's test inputs, sequential forward and ``jax.grad``."""
    S, B, D = 4, 8, 16
    ws = jax.random.normal(jax.random.PRNGKey(0), (S, D, D)) * 0.3
    x = jax.random.normal(jax.random.PRNGKey(1), (B, D))

    def loss_seq(ws_):
        h = x
        for i in range(S):
            h = jnp.tanh(h @ ws_[i])
        return jnp.sum(h ** 2), h

    (_, ref), g = jax.value_and_grad(loss_seq, has_aux=True)(ws)
    return {"ws": np.asarray(ws), "x": np.asarray(x), "ref": np.asarray(ref),
            "grads": np.asarray(g)}


JAX_COMPRESSION = r'''
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.runtime import compression
root = sys.argv[1]
inp = np.load(f"{root}/comp_in.npz")
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
g, gr, er = (jnp.asarray(inp[k]) for k in ("g", "gr", "er"))
mean, err = compression.compressed_crosspod_mean(g, jnp.zeros_like(g), mesh)
mean2, err2 = compression.compressed_crosspod_mean(g, err, mesh)
rmean, rerr = compression.compressed_crosspod_mean(gr, er, mesh)
np.savez(f"{root}/comp_out.npz", mean=mean, err=err, mean2=mean2, err2=err2,
         rmean=rmean, rerr=rerr)
'''


def _jax_compression(root, inputs):
    """JAX's own ``compressed_crosspod_mean`` on (pod 2, data 2, model 2)
    forced host devices (a child process, as tests/test_distributed.py
    runs it): JAX's test tensor twice (error feedback), and the ragged
    pod-0 tensor with its residual; its inputs are replicated, so both
    pods hold the same value."""
    np.savez(f"{root}/comp_in.npz", g=inputs["g"], gr=inputs["g_pod"][0],
             er=inputs["e_pod"][0])
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    r = subprocess.run([sys.executable, "-c", JAX_COMPRESSION, root],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    with np.load(f"{root}/comp_out.npz") as f:
        return {k: f[k] for k in f.files}


def _jax_pod_mean(g_pod, e_pod):
    """JAX's compression body with a different tensor on each pod, run op
    by op as JAX's ``shard_map`` runs it outside ``jit``: each pod
    quantizes its target, the mean dequantizes them in pod order."""
    shape = g_pod[0].shape

    def body(gs, es):
        qs, news = [], []
        for g, e in zip(gs, es):
            target = g.astype(jnp.float32) + e
            q, s = jcomp._quant_block(target)
            news.append(target - jcomp._dequant_block(q, s, shape))
            qs.append((q, s))
        total = jnp.zeros(shape, jnp.float32)
        for q, s in qs:
            total = total + jcomp._dequant_block(q, s, shape)
        return total / len(gs), news

    mean, news = body(list(g_pod), list(e_pod))
    return np.asarray(mean), [np.asarray(e) for e in news]


@pytest.fixture(scope="module")
def runs():
    tmp = tempfile.TemporaryDirectory(prefix="mesh_train_")
    root = tmp.name
    rng = np.random.default_rng(7)
    gpipe = _jax_gpipe()
    jb = JSyntheticLM(jreg.smoke_config(GRANITE), BATCH, SEQ, seed=0,
                      host_index=0, host_count=1)
    batches = [jb.batch_at(s) for s in range(STEPS)]
    dpipe = SyntheticLM(treg.smoke_config(DANUBE), BATCH, SEQ, seed=1,
                        host_index=0, host_count=1)
    inputs = {
        "lr": LR, "steps": STEPS, "batch": BATCH, "seq": SEQ, "warm": WARM,
        "granite_batch": _granite_batch(),
        "danube_batches": [dpipe.batch_at(s) for s in range(2)],
        "ws": gpipe["ws"], "x": gpipe["x"],
        "g": np.asarray(jax.random.normal(jax.random.PRNGKey(0), (64, 128))),
        # ragged (the last block padded), a different tensor per pod
        "g_pod": [(rng.standard_normal((37, 91)) * s).astype(np.float32)
                  for s in (1.0, 3.0)],
        "e_pod": [(rng.standard_normal((37, 91)) * 1e-3).astype(np.float32)
                  for _ in range(2)]}
    torch.save(inputs, f"{root}/inputs.pt")
    cmd = [sys.executable, "-c", RANK_PROGRAM, root]
    with ThreadPoolExecutor(3) as ex:
        ranks8 = ex.submit(tdist.launch, cmd, 8, env=ENV, cwd=ROOT,
                           timeout=300)
        jcomp_run = ex.submit(_jax_compression, root, inputs)
        gcfg = treg.smoke_config(GRANITE)
        tp0 = TM.init(gcfg, torch.Generator().manual_seed(0))
        jg = ex.submit(_jax_granite, tp0, batches, inputs["granite_batch"])
        single = train_loop.train(gcfg, tadamw.AdamWConfig(lr=LR),
                                  train_loop.TrainConfig(
                                      steps=STEPS, global_batch=BATCH,
                                      seq_len=SEQ, seed=0, log_every=0),
                                  device="cpu")
        gdirect = _port_direct(gcfg, tadamw.AdamWConfig(lr=LR),
                               [inputs["granite_batch"]])
        dcfg = dataclasses.replace(
            treg.smoke_config(DANUBE),
            sparsity=tlin.SparsityConfig(pattern=(6, 8), mode="masked"))
        ddirect = _port_direct(dcfg, tadamw.AdamWConfig(
            lr=3e-3, state_dtype="int8"), inputs["danube_batches"])
        pod_mean = _jax_pod_mean(inputs["g_pod"], inputs["e_pod"])
        mini = TM.init(treg.smoke_config(MINITRON),
                       torch.Generator().manual_seed(0))
        ckpt.save(f"{root}/single", 1, tree.tree_map(lambda x: x + 1, mini))
        ranks8.result()
        r8 = [torch.load(f"{root}/rank{r}.pt", weights_only=False)
              for r in range(8)]
        tdist.launch(cmd, 4, env=ENV, cwd=ROOT, timeout=120)
        r4 = [torch.load(f"{root}/rank{r}.pt", weights_only=False)
              for r in range(4)]
        granite_restored = ckpt.restore(
            f"{root}/granite_ckpt", {"opt": single["opt_state"],
                                     "params": single["params"]},
            device="cpu")[0]
        elastic_whole = ckpt.restore(f"{root}/elastic", mini,
                                     device="cpu")[0]
        out = {"r8": r8, "r4": r4, "jax": jg.result(), "single": single,
               "gdirect": gdirect, "ddirect": ddirect, "gpipe": gpipe,
               "inputs": inputs, "pod_mean": pod_mean, "tp0": tp0,
               "dcfg": dcfg, "mini": mini, "jcomp": jcomp_run.result(),
               "granite_restored": granite_restored,
               "elastic_whole": elastic_whole}
    yield out
    tmp.cleanup()


# ----------------------------------------------------- train(mesh=...)
def test_train_over_mesh_equals_single_device_and_jax(runs):
    r0 = runs["r8"][0]["train"]
    single, jx = runs["single"], runs["jax"]
    np.testing.assert_allclose(r0["losses"], single["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(r0["losses"], jx["losses"], rtol=LOSS_RTOL)
    want_jax = _unit_leaves(jx["params"], single["params"])
    for path, a, b, j in zip(tree.paths(single["params"]),
                             tree.leaves(r0["params"]),
                             tree.leaves(single["params"]), want_jax):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(),
                                   atol=P_ATOL, rtol=P_RTOL, err_msg=str(path))
        np.testing.assert_allclose(a.numpy(), j, atol=P_ATOL, rtol=P_RTOL,
                                   err_msg=str(path))
    # every rank ends with the same whole parameters and losses
    for r in runs["r8"][1:]:
        assert r["train"]["losses"] == r0["losses"]
        assert all(torch.equal(a, b) for a, b in zip(
            tree.leaves(r["train"]["params"]), tree.leaves(r0["params"])))
    assert r0["collectives"] > 0


def test_resume_over_mesh_is_exact(runs):
    """2 steps, a checkpoint, a resume to 3: the uninterrupted run's
    parameters bit for bit (the resumed call runs only step 2)."""
    r0 = runs["r8"][0]
    assert r0["resumed"]["losses"] == r0["train"]["losses"][-1:]
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(r0["resumed"]["params"]),
        tree.leaves(r0["train"]["params"])))


def test_sharded_checkpoint_restores_on_one_device(runs):
    """The mesh run's checkpoint holds whole arrays: restored on one
    device they are the gathered pieces."""
    got = runs["granite_restored"]["params"]
    want = runs["r8"][0]["train"]["params"]
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(got),
                                                 tree.leaves(want)))


def test_each_rank_holds_only_its_pieces(runs):
    for r in runs["r8"]:
        # granite at (2, 2, 2): the big leaves split 4 ways, norms whole
        assert r["resident"] < 0.5 * r["logical"], (r["resident"],
                                                    r["logical"])
        for key in ("direct_None", "danube_int8"):
            assert r[key]["local_ok"], key
            assert r[key]["resident"] < 0.5 * sum(
                x.numel() * x.element_size() for x in
                tree.leaves(r[key]["params"]) + tree.leaves(r[key]["state"]))


# ------------------------------------------- the direct step and faults
def _compare(got, port, jx, tp0):
    """Which of loss, grads and params a sharded step's results keep
    within tolerance, against the port's and JAX's single-device step."""
    ok = {"loss": abs(got["loss"] - port["loss"]) <= LOSS_RTOL * abs(
        port["loss"]) and abs(got["loss"] - jx["loss"]) <= LOSS_RTOL * abs(
        jx["loss"])}
    jgrads = _unit_leaves(jx["grads"], tp0)
    worst = max(max(_rl2(a, b), _rl2(a, j)) for a, b, j in
                zip(got["grads"], port["grads"], jgrads))
    ok["grads"] = worst <= GRAD_RL2
    jparams = _unit_leaves(jx["params"], tp0)
    ok["params"] = all(
        np.allclose(a.numpy(), b.detach().numpy(), atol=P_ATOL, rtol=P_RTOL)
        and np.allclose(a.numpy(), j, atol=P_ATOL, rtol=P_RTOL)
        for a, b, j in zip(tree.leaves(got["params"]),
                           tree.leaves(port["params"]), jparams))
    return ok, worst


def test_sharded_step_equals_single_device_and_jax(runs):
    got = runs["r8"][0]["direct_None"]
    ok, worst = _compare(got, runs["gdirect"], runs["jax"]["direct"],
                         runs["tp0"])
    assert all(ok.values()), (ok, worst)
    # the step moved the parameters by the full rate (not warmup's 0)
    moved = max(float((a - b).abs().max()) for a, b in zip(
        tree.leaves(got["params"]), tree.leaves(runs["tp0"])))
    assert moved > 0.5 * LR


@pytest.mark.parametrize("fault", ["skip_dp_sum", "mean_of_means"])
def test_planted_faults_fail_the_comparison(runs, fault):
    got = runs["r8"][0][f"direct_{fault}"]
    ok, worst = _compare(got, runs["gdirect"], runs["jax"]["direct"],
                         runs["tp0"])
    assert not ok["grads"] and worst > 10 * GRAD_RL2, (fault, worst)
    if fault == "mean_of_means":
        assert not ok["loss"], got["loss"]


def _single_device_update(cfg, opt, step_grads):
    """The single-device AdamW of ``opt`` from the seed-0 init at WARM,
    fed the given gradients (whole leaves) step by step."""
    params = TM.init(cfg, torch.Generator().manual_seed(0))
    state = tadamw.init(params, opt)._replace(
        step=torch.tensor(WARM, dtype=torch.int32))
    for grads in step_grads:
        params, state, _ = tadamw.update(
            params, tree.unflatten(params, grads), state, opt,
            tschedule.warmup_cosine(state.step))
    return state


def test_int8_moments_sharded_equal_single_device(runs):
    """The sharded int8 AdamW state equals the single-device AdamW's fed
    the same gradients, and those gradients (each step's) equal the
    single device's.  The split along ``model`` sums partial products in
    another order than one device (relative L2 ~1e-6), and an int8 moment
    rounds such a difference to a whole step now and then (one or two of
    2048-8192 values in a few leaves, measured): the int8 state is held on
    the gradients it was given."""
    got, want = runs["r8"][0]["danube_int8"], runs["ddirect"]
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    for a, b in zip(got["grads"], want["grads"]):
        assert _rl2(a, b) <= GRAD_RL2
    for step, grads in zip(got["step_grads"], want["step_grads"]):
        for a, b in zip(step, grads):
            assert _rl2(a, b) <= GRAD_RL2
    for path, a, b in zip(tree.paths(want["params"]),
                          tree.leaves(got["params"]),
                          tree.leaves(want["params"])):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(),
                                   atol=P_ATOL, rtol=P_RTOL, err_msg=str(path))
    gs = got["state"]
    ws = _single_device_update(runs["dcfg"], tadamw.AdamWConfig(
        lr=3e-3, state_dtype="int8"), got["step_grads"])
    assert int(gs.step) == int(ws.step) == WARM + 2
    for q, s, wq, wsc in ((gs.mu, gs.mu_scale, ws.mu, ws.mu_scale),
                          (gs.nu, gs.nu_scale, ws.nu, ws.nu_scale)):
        for a, sa, b, sb in zip(tree.leaves(q), tree.leaves(s),
                                tree.leaves(wq), tree.leaves(wsc)):
            da = tadamw._blockwise_dequant(a, sa, 256)
            db = tadamw._blockwise_dequant(b, sb, 256)
            assert _rl2(da, db) <= STATE_RL2


def test_moe_group_rule_refuses_droppable_groups(runs):
    for r in runs["r8"]:
        assert r["moe_refused"] is not None and "ROADMAP" in \
            r["moe_refused"], r["moe_refused"]


# --------------------------------------------------------------- GPipe
def test_gpipe_equals_sequential_jax(runs):
    ref = runs["gpipe"]
    for r in runs["r8"]:
        np.testing.assert_allclose(r["gpipe"]["out"].numpy(), ref["ref"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["gpipe"]["grads"].numpy(),
                                   ref["grads"], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------- compression
def test_compression_properties_of_jax_test(runs):
    """JAX's test: the same tensor on both pods -> mean ~= g, the residual
    held exactly, and a second step with error feedback no worse."""
    g = runs["inputs"]["g"]
    for r in runs["r8"]:
        c = r["compression"]
        mean, err = c["mean"].numpy(), c["err"].numpy()
        err_rms = float(np.sqrt(np.mean((mean - g) ** 2)))
        assert err_rms < 0.05 * float(np.std(g)), err_rms
        np.testing.assert_allclose(err, g - mean, atol=1e-6)
        drift1 = float(np.mean(np.abs(mean - g)))
        two = float(np.mean(np.abs((mean + c["mean2"].numpy()) / 2 - g)))
        assert two <= drift1 + 1e-6
        assert c["no_pod_is_identity"]


def test_compression_equals_jax_function(runs):
    """The same inputs as JAX's own function on its forced devices (both
    pods the same tensor): every output bit-equal, error feedback too."""
    want = runs["jcomp"]
    for r in runs["r8"]:
        c = r["compression"]
        for k in ("mean", "err", "mean2", "err2", "rmean", "rerr"):
            np.testing.assert_array_equal(c[k].numpy(), want[k], err_msg=k)


def test_tree_compression_is_per_leaf(runs):
    for r in runs["r8"]:
        c = r["compression"]
        a, b, ea, eb = c["tree"]
        assert torch.equal(a, c["mean"]) and torch.equal(ea, c["err"])
        assert torch.equal(b, c["pod_mean"]) and torch.equal(eb, c["pod_err"])


def test_production_mesh_needs_its_rank_count(runs):
    """As ``jax.make_mesh`` fails on too few devices: 16 x 16 over 8 ranks
    raises, naming both counts."""
    for r in runs["r8"]:
        assert "needs 256 ranks; the world has 8" in r["production"]


def test_compression_equals_jax_math(runs):
    """Different tensors on the two pods (ragged: the last block padded):
    the mean and each pod's residual bit-equal to JAX's compiled body;
    the wire carries the int8 blocks and fp32 scales."""
    mean, errs = runs["pod_mean"]
    g = runs["inputs"]["g_pod"][0]
    nblocks = -(-g.size // 256)
    for rank, r in enumerate(runs["r8"]):
        c = r["compression"]
        np.testing.assert_array_equal(c["pod_mean"].numpy(), mean)
        np.testing.assert_array_equal(c["pod_err"].numpy(), errs[rank // 4])
        assert c["wire"] == nblocks * 256 + nblocks * 4


# -------------------------------------------------------------- elastic
def test_elastic_restore_onto_a_smaller_mesh(runs):
    assert runs["r8"][0]["elastic_mesh"] == {"data": 1, "model": 8}
    whole = runs["elastic_whole"]
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(whole),
                                                 tree.leaves(runs["mini"])))
    for r in runs["r4"]:
        e = r["elastic"]
        assert e["shape"] == {"data": 2, "model": 2} and e["step"] == 3
        for key in ("reshard", "restore", "single", "gather"):
            assert e[key] and all(e[key]), key
        assert e["sharded"]
