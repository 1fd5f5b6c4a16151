"""The encoder-decoder's split train step and the token-split LM head,
over gloo ranks on the CPU, held against JAX's single-device
``train_step``.

whisper splits its encoder, decoder and cross-attention by heads and its
GELU MLP by d_ff (``w_in`` column-, ``w_out`` row-parallel), the encoder
output entering the cross K/V once through ``tp.copy_in``.  Where t does
not divide the vocabulary the LM head splits the tokens: the head whole
on every rank, each rank taking its 1/t block of the sequence, the (NLL,
count) pair totalled over the ranks.  The smoke vocab (128) keeps the
vocab-parallel head; an odd one (131, on both sides) takes the
token-split head.

One module fixture starts 2 ranks and 4 ranks at once and meanwhile
compiles JAX's step for each (arch, vocab) here, as
``tests/test_torch_tp_train.py`` does, at its tolerances.  Cases:
- 2 ranks: whisper over (data 1, model 2) with the smoke vocab; granite
  with vocab 131 over (1, 2), SP off and on; whisper with vocab 131 under
  three planted faults (``enc_out`` entering without the all-reduce in
  its backward; the head's (NLL, count) left unsummed; the lm_head's
  gradient left unsummed);
- 4 ranks: whisper with vocab 131 over (1, 4) and over (2, 2).
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
from repro.sharding import tp as jtp

from repro_torch import tree
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.core import linear as tlin
from repro_torch.launch import dryrun
from repro_torch.models import transformer as ttrans
from repro_torch.runtime import steps as tsteps
from repro_torch.sharding import ctx, dist as tdist, tp

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
WHISPER, GRANITE = "whisper-small", "granite-moe-3b-a800m"
ODD = 131          # divides by no t > 1: the token-split head
BATCH, SEQ, LR, WARM = 8, 32, 1e-3, 100
# tests/test_torch_tp_train.py's tolerances
LOSS_RTOL, P_ATOL, P_RTOL = 2e-4, 5e-4, 2e-2
GRAD_RL2 = 1e-5
FAST_XLA = {"xla_backend_optimization_level": 0}
# JAX traces one step at a time (two threads tracing at once have
# crashed the interpreter); XLA compiles them in parallel
_TRACE = threading.Lock()
FAULTS = ("enc_out_no_sum", "head_nll_unsummed", "head_grad_unsummed")

# case -> (arch, vocab, (data, model), sequence_parallel, fault)
CASES = {
    "whisper_1x2": (WHISPER, 128, (1, 2), False, None),
    "granite_1x2": (GRANITE, ODD, (1, 2), False, None),
    "granite_1x2_sp": (GRANITE, ODD, (1, 2), True, None),
    **{f"whisper_1x2_{f}": (WHISPER, ODD, (1, 2), False, f) for f in FAULTS},
    "whisper_1x4": (WHISPER, ODD, (1, 4), False, None),
    "whisper_2x2": (WHISPER, ODD, (2, 2), False, None),
}
REFS = sorted({c[:2] for c in CASES.values()})   # (arch, vocab)

RANK_PROGRAM = r'''
import dataclasses, sys
import torch
from repro_torch import tree
from repro_torch.configs import registry as treg
from repro_torch.core.linear import SparsityConfig
from repro_torch.models import encdec, transformer
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
    if fault == "enc_out_no_sum":
        orig = encdec._cross_in
        encdec._cross_in = lambda x: x
        return lambda: setattr(encdec, "_cross_in", orig)
    if fault == "head_nll_unsummed":
        orig = transformer._token_sum
        transformer._token_sum = lambda total, count: (total, count)
        return lambda: setattr(transformer, "_token_sum", orig)
    if fault == "head_grad_unsummed":
        orig = transformer._token_block

        def unsummed(lm_head, h, labels):
            return (lm_head,) + orig(lm_head, h, labels)[1:]
        transformer._token_block = unsummed
        return lambda: setattr(transformer, "_token_block", orig)
    return lambda: None


def run(name, arch, vocab, sizes, sp, fault):
    cfg = dataclasses.replace(
        treg.smoke_config(arch), vocab_size=vocab, sequence_parallel=sp,
        sparsity=SparsityConfig(pattern=(6, 8), mode="masked"))
    opt = adamw.AdamWConfig(lr=inp["lr"])
    mesh = ctx.Mesh(sizes, ("data", "model"), device="cpu")
    key = f"{arch}@{vocab}"
    whole = tree.tree_map(lambda x: x.clone(), inp["p0"][key])
    params, state, lay = train_loop._sharded_init(whole, opt, mesh)
    state = state._replace(step=torch.tensor(inp["warm"], dtype=torch.int32))
    batches = [{k: rules.cut(torch.from_numpy(v), rules.batch_spec(
        torch.from_numpy(v), mesh), mesh) for k, v in b.items()}
        for b in inp["batches"][key]]
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
        out = {"loss": float(loss), "kinds": ctx.collectives_by_kind(),
               "t": steps.split_degree(cfg, mesh),
               "grads": [rules.gather_leaf(g, s, mesh)
                         for g, s in zip(grads, lay.params)],
               "shards": seen[0]}
        if fault is None:
            for b in batches:
                params, state, _ = steps.train_step(cfg, opt, params, state,
                                                    b, layout=lay)
            out["params"] = rules.gather(params, lay.params, mesh)
    finally:
        steps.M.loss_fn = orig_loss
        undo()
    return out


for name, (arch, vocab, sizes, sp, fault) in inp["cases"].items():
    if sizes[0] * sizes[1] == world:
        res[name] = run(name, arch, vocab, sizes, sp, fault)
torch.save(res, f"{root}/rank{world}_{rank}.pt")
'''


def _cfgs(arch, vocab):
    sp = dict(pattern=(6, 8), mode="masked")
    return (dataclasses.replace(jreg.smoke_config(arch), vocab_size=vocab,
                                sparsity=jlin.SparsityConfig(**sp)),
            dataclasses.replace(treg.smoke_config(arch), vocab_size=vocab,
                                sparsity=tlin.SparsityConfig(**sp)))


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_init(arch, vocab):
    """JAX's init and two batches, as numpy."""
    jcfg, _ = _cfgs(arch, vocab)
    p0 = jax.jit(JM.init, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    pipe = JSyntheticLM(jcfg, BATCH, SEQ, seed=0, host_index=0, host_count=1)
    return {"p0": _np(p0), "batches": [pipe.batch_at(s) for s in range(2)]}


def _jax_steps(arch, vocab, init):
    """JAX's jitted single-device step from the init at step counter
    WARM: the first step's loss and gradients (read off its first
    moment) and the params after both steps."""
    jcfg, _ = _cfgs(arch, vocab)
    opt = jadamw.AdamWConfig(lr=LR)
    with _TRACE:
        p0 = jax.tree_util.tree_map(jnp.asarray, init["p0"])
        state = jadamw.init(p0, opt)._replace(
            step=jnp.asarray(WARM, jnp.int32))
        jb = [{k: jnp.asarray(v) for k, v in b.items()}
              for b in init["batches"]]
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
    """JAX's inits first; then the 2 and 4 ranks beside JAX's steps."""
    tmp = tempfile.TemporaryDirectory(prefix="tp_train_encdec_")
    root = tmp.name
    inits = {r: _jax_init(*r) for r in REFS}
    port = {r: {"p0": params_from_jax(inits[r]["p0"], _cfgs(*r)[1],
                                      device="cpu")} for r in REFS}
    torch.save({"lr": LR, "warm": WARM, "cases": CASES,
                "p0": {f"{a}@{v}": port[(a, v)]["p0"] for a, v in REFS},
                "batches": {f"{a}@{v}": inits[(a, v)]["batches"]
                            for a, v in REFS}},
               f"{root}/inputs.pt")
    cmd = [sys.executable, "-c", RANK_PROGRAM, root]
    with ThreadPoolExecutor(5) as ex:
        done = [ex.submit(tdist.launch, cmd, n, env=ENV, cwd=ROOT,
                          timeout=300) for n in (2, 4)]
        jx = {r: ex.submit(_jax_steps, *r, inits[r]) for r in REFS}
        jx = {r: f.result() for r, f in jx.items()}
        for f in done:
            f.result()
    for r in REFS:
        port[r].update({k: params_from_jax(jx[r][k], _cfgs(*r)[1],
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
    arch, vocab, sizes = CASES[name][:3]
    return runs["ranks"][sizes[0] * sizes[1]], (arch, vocab)


def _worst(got, want):
    return max(_rl2(a, b) for a, b in zip(got, tree.leaves(want)))


SOUND = [n for n, c in CASES.items() if c[4] is None]
# the split degree each sound case takes: min(model, what the heads allow)
T = {"whisper_1x2": 2, "granite_1x2": 2, "granite_1x2_sp": 2,
     "whisper_1x4": 4, "whisper_2x2": 2}


@pytest.mark.parametrize("name", SOUND)
def test_split_step_equals_jax_single_device(runs, name):
    """Loss, gathered gradients and the params after two steps, on every
    rank, against JAX's jitted single-device step."""
    ranks, ref = _case(runs, name)
    want = runs["port"][ref]
    jloss = runs["jax"][ref]["loss"]
    for r in ranks:
        got = r[name]
        assert got["t"] == T[name]
        assert abs(got["loss"] - jloss) <= LOSS_RTOL * abs(jloss)
        bad = [(p, _rl2(a, b)) for p, a, b in zip(
            tree.paths(want["grads"]), got["grads"],
            tree.leaves(want["grads"])) if _rl2(a, b) > GRAD_RL2]
        assert not bad, (name, bad)
        for path, a, b in zip(tree.paths(want["params"]),
                              tree.leaves(got["params"]),
                              tree.leaves(want["params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=P_ATOL,
                                       rtol=P_RTOL, err_msg=f"{name} {path}")
    moved = max(float((a - b).abs().max()) for a, b in zip(
        tree.leaves(ranks[0][name]["params"]), tree.leaves(want["p0"])))
    assert moved > 0.5 * LR


@pytest.mark.parametrize("name", SOUND)
def test_compute_shards_are_a_tth_of_each_role_leaf(runs, name):
    """``M.loss_fn`` gets 1/t of every leaf a training role splits (the
    attention projections of every kind, ``w_in`` / ``w_out``, the MoE
    experts), each other leaf whole; the LM head is split along the
    vocabulary where t divides it and whole where it splits the tokens."""
    ranks, (arch, vocab) = _case(runs, name)
    p0 = runs["port"][(arch, vocab)]["p0"]
    names = [[k for k in path if isinstance(k, str)]
             for path in tree.paths(p0)]
    t = T[name]
    vp = vocab % t == 0
    for r in ranks:
        for nm, x, shape in zip(names, tree.leaves(p0), r[name]["shards"]):
            dim = tp.shard_dim(nm, x.dim(), vocab_parallel=vp)
            want = list(x.shape)
            if dim is not None:
                want[dim] //= t
            assert list(shape) == want, (name, nm, shape, want)
            if nm[0] == "lm_head":
                assert shape[0] == (vocab // t if vp else vocab)
    roles = {tuple(n for n in nm[:-1] if n in (
        "encoder", "self_attn", "cross_attn", "attn", "mlp", "ffn")) + (
        nm[-2],) for nm, x in zip(names, tree.leaves(p0))
        if tp.shard_dim(nm, x.dim(), vocab_parallel=vp)
        is not None}
    if arch == WHISPER:
        attn = {(*k, w) for k in (("encoder", "attn"), ("self_attn",),
                                  ("cross_attn",))
                for w in ("wq", "wk", "wv", "wo")}
        mlp = {("encoder", "mlp", "w_in"), ("encoder", "mlp", "w_out"),
               ("mlp", "w_in"), ("mlp", "w_out")}
        assert roles == attn | mlp | ({("lm_head",)} if vp else set())
    else:
        assert not vp and ("lm_head",) not in roles
        assert {r[-1] for r in roles} == {"wq", "wk", "wv", "wo", "w_gate",
                                           "w_up", "w_down"}


def test_token_split_head_with_sequence_parallel_equals_off(runs):
    """Under Megatron-SP the token-split head reads the rank's S-block of
    the residual stream as it is (no gather): the same loss, gradients
    and params after two steps as with SP off."""
    for r in runs["ranks"][2]:
        on, off = r["granite_1x2_sp"], r["granite_1x2"]
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
    """``enc_out`` entering the cross K/V without the all-reduce in its
    backward leaves the encoder one rank's partial gradient; the head's
    (NLL, count) unsummed makes each rank's loss its own block's mean;
    the lm_head's gradient unsummed keeps one block's share: each reads
    far past the gradient tolerance."""
    want = runs["port"][(WHISPER, ODD)]["grads"]
    jloss = runs["jax"][(WHISPER, ODD)]["loss"]
    for r in runs["ranks"][2]:
        got = r[f"whisper_1x2_{fault}"]
        assert got["t"] == 2
        assert _worst(got["grads"], want) > 10 * GRAD_RL2, fault
        if fault == "head_nll_unsummed":
            assert abs(got["loss"] - jloss) > LOSS_RTOL * abs(jloss)


def test_token_split_refuses_s_not_divisible_by_t():
    """The token-split head cuts S into t blocks: S % t != 0 raises, and
    never runs the head unsplit."""
    _, cfg = _cfgs(WHISPER, ODD)
    lm_head = {"w": torch.zeros(ODD, cfg.d_model)}
    h = torch.zeros(2, 30, cfg.d_model)
    labels = torch.zeros(2, 30, dtype=torch.int32)
    with tp.activate_dry(4), pytest.raises(ValueError, match="S % t"):
        ttrans.chunked_xent(lm_head, cfg, h, labels)


def test_split_degrees_on_16x16_and_serving_unchanged():
    """A training step on a 16x16 mesh splits whisper-small 4 ways (12
    heads) and granite-moe 8 ways (8 KV heads), whatever the vocabulary;
    every other arch splits as the serving degree it had; serving still
    refuses a vocabulary tp does not divide, with JAX's message."""
    mesh = ctx.Mesh.abstract({"data": 16, "model": 16})
    train = {a: tsteps.split_degree(treg.get(a), mesh) for a in treg.ARCH_IDS}
    assert train[WHISPER] == 4 and train[GRANITE] == 8
    assert {a: t for a, t in train.items() if a not in (WHISPER, GRANITE)} \
        == {a: tp.degree(treg.get(a), 16) for a in treg.ARCH_IDS
            if a not in (WHISPER, GRANITE)}
    assert tp.degree(treg.get(GRANITE), 16) == 1
    assert dryrun.serve_tp(treg.get(WHISPER), 16) == 1
    for arch, t in ((WHISPER, 4), (GRANITE, 8)):
        tp.validate(treg.get(arch), t, train=True)
        with pytest.raises(ValueError) as want:
            jtp.validate(jreg.get(arch), t)
        with pytest.raises(ValueError, match="vocab_size") as got:
            tp.validate(treg.get(arch), t)
        assert str(got.value) == str(want.value)
