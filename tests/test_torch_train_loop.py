"""The port's training substrate held against the JAX package's, on the CPU.

* ``masks.magnitude_mask`` and the ``ste_prune`` forward bit-equal to
  JAX's (weights with magnitude ties, fp32 and bf16, 6:8, 2:4, 14:16);
  the ``ste_prune`` backward the identity, bit for bit, as JAX's VJP;
  ``mode="masked"`` through ``linear.apply`` and ``prepare``.
* ``steps.train_step`` at ``accum=2`` equal to ``accum=1`` (JAX's own
  test's tolerance) and to JAX's jitted ``accum=2`` step (loss rtol
  1e-5; params and moments within relative L2 1e-4).
* ``adamw.update`` with fp32 and int8 moments against JAX's on the same
  params and grads, three steps: params within 1e-6 relative L2 (the
  clip factor comes from a global norm summed in another order), fp32
  moments within 1e-6, int8 moments equal but for entries one code
  apart at rounding ties (INT8_TIES of the 2 x 2608 codes: none on
  these inputs);
  clipping, ``block_for`` and the blockwise quantizer's bound.
* ``warmup_cosine`` at steps 0, 1, 99, 100, 101, 5000, 10000, 20000.
* ``_remat_split`` for U = 1..64.
* ``SyntheticLM.batch_at`` bit-equal to JAX's (danube, whisper's audio
  frames, qwen2-vl's vision embeddings) at two hosts; the prefetcher.
* Remat on (2 x 3 segments of 6 units) and off, bit-equal loss and
  gradients.
* The checkpointer: round trip with bf16, e4m3, int8 and int32 leaves
  (bit-exact), no partial checkpoint visible, async saves with gc,
  structure and shape mismatches refused (``tests/test_substrate.py``'s
  cases).
* The loop (``tests/test_train_integration.py``'s cases): loss decreases
  for dense, MoE and SSM stacks, resume is exact, int8 state trains, the
  straggler monitor; ``launch.train.main`` at smoke size; the card by
  default.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import linear as jlin, masks as jmasks
from repro.core.patterns import Pattern
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import moe as jmoe, transformer as jtrans
from repro.optim import adamw as jadamw, schedule as jschedule

from repro_torch import tree
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import registry as treg
from repro_torch.core import linear as tlin, masks as tmasks
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import model as TM, moe as tmoe
from repro_torch.models import transformer as ttrans
from repro_torch.optim import adamw, schedule
from repro_torch.runtime import steps, train_loop

INT8_TIES = 0


# ---------------------------------------------------------------- optimizer
def _toy(seed):
    """Params and three steps of grads (numpy), JAX's toy tree plus a
    leaf whose last dim is blocked (block 256 of 512)."""
    rng = np.random.default_rng(seed)

    def draw(scale):
        return {k: (rng.standard_normal(s) * scale).astype(np.float32)
                for k, s in (("a", (8, 64)), ("c", (4, 512)), ("g", (16,)),
                             ("w", (32,)))}

    return draw(1.0), [draw(0.3) for _ in range(3)]


def _jax_tree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _torch_tree(t):
    return tree.tree_map(lambda a: torch.from_numpy(np.array(a)), t)


def _rl2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_adamw_update_matches_jax(state_dtype):
    params, grads = _toy(0)
    jcfg = jadamw.AdamWConfig(lr=0.05, state_dtype=state_dtype, block=256)
    tcfg = adamw.AdamWConfig(lr=0.05, state_dtype=state_dtype, block=256)
    jp, tp = _jax_tree(params), _torch_tree(params)
    js, ts = jadamw.init(jp, jcfg), adamw.init(tp, tcfg)
    for i, g in enumerate(grads):
        scale = 0.5 + i  # lr_scale as a 0-d array, as the schedule gives it
        jp, js, jm = jadamw.update(jp, _jax_tree(g), js, jcfg,
                                   jnp.float32(scale))
        tp, ts, tm = adamw.update(tp, _torch_tree(g), ts, tcfg,
                                  torch.tensor(scale))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
    assert int(ts.step) == int(js.step) == 3
    for a, b in zip(tree.leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert _rl2(a, b) <= 1e-6
    moments = zip(tree.leaves([ts.mu, ts.nu]),
                  jax.tree_util.tree_leaves([js.mu, js.nu]))
    if state_dtype == "float32":
        for a, b in moments:
            assert _rl2(a, b) <= 1e-6
        assert ts.mu_scale is None and ts.nu_scale is None
        return
    ties = 0
    for a, b in moments:
        assert a.dtype == torch.int8 and a.shape == b.shape
        d = np.abs(a.numpy().astype(np.int32) - np.asarray(b, np.int32))
        assert d.max() <= 1
        ties += int(d.sum())
    assert ties <= INT8_TIES, ties
    for a, b in zip(tree.leaves([ts.mu_scale, ts.nu_scale]),
                    jax.tree_util.tree_leaves([js.mu_scale, js.nu_scale])):
        assert a.shape == b.shape and _rl2(a, b) <= 1e-5


def test_grad_clip_and_block_for():
    cfg = adamw.AdamWConfig(lr=0.0, grad_clip=1.0)
    params = {"w": torch.zeros(4)}
    _, _, m = adamw.update(params, {"w": torch.full((4,), 1e6)},
                           adamw.init(params, cfg), cfg)
    assert float(m["grad_norm"]) > 1e6  # reported before clipping
    for last, target in ((6144, 256), (240, 256), (7, 256), (3840, 256),
                         (10240, 256), (32000, 256)):
        assert adamw.block_for(last, target) == jadamw.block_for(last, target)


def test_int8_state_roundtrip_bound():
    x = torch.randn(4, 256, generator=torch.Generator().manual_seed(1)) * 5
    q, s = adamw._blockwise_quant(x, 64)
    assert q.shape == x.shape and q.dtype == torch.int8
    jq, js = jadamw._blockwise_quant(jnp.asarray(x.numpy()), 64)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    err = (adamw._blockwise_dequant(q, s, 64) - x).abs()
    assert bool((err <= s.repeat_interleave(64, -1) / 2 + 1e-7).all())


def test_warmup_cosine_matches_jax():
    for step in (0, 1, 99, 100, 101, 5000, 10000, 20000):
        want = float(jschedule.warmup_cosine(step))
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            got = schedule.warmup_cosine(arg)
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)
    assert float(schedule.warmup_cosine(0, warmup=10, total=100)) == 0.0


def test_aux_load_balance_loss_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 16, 8)).astype(np.float32)
    top = np.argsort(-logits, axis=-1, kind="stable")[..., :2].astype(np.int32)
    want = float(jmoe.aux_load_balance_loss(jnp.asarray(logits),
                                            jnp.asarray(top), 8))
    got = tmoe.aux_load_balance_loss(torch.from_numpy(logits),
                                     torch.from_numpy(top), 8)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_remat_split_matches_jax():
    for u in range(1, 65):
        assert ttrans._remat_split(u) == jtrans._remat_split(u), u


# ------------------------------------------------------------------ masks
def _tied(rng, shape):
    """Weights on a coarse grid (many magnitude ties, zeros included)."""
    return (rng.integers(-4, 5, size=shape) * 0.25).astype(np.float32)


@pytest.mark.parametrize("zl", [(6, 8), (2, 4), (14, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask_and_ste_forward_bit_equal(zl, dtype):
    pat = Pattern(*zl)
    w = _tied(np.random.default_rng(zl[1]), (3, 12, 64))
    wj = jnp.asarray(w).astype(dtype)
    wt = torch.from_numpy(w).to(getattr(torch, dtype))
    np.testing.assert_array_equal(np.asarray(jmasks.magnitude_mask(wj, pat)),
                                  tmasks.magnitude_mask(wt, pat).numpy())
    want = np.asarray(jmasks.ste_prune(wj, pat).astype(jnp.float32))
    got = tmasks.ste_prune(wt, pat)
    assert got.dtype == wt.dtype
    np.testing.assert_array_equal(got.to(torch.float32).numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_ste_backward_is_identity():
    rng = np.random.default_rng(5)
    pat = Pattern(6, 8)
    w = _tied(rng, (16, 64))
    g = rng.standard_normal((16, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jmasks.ste_prune(x, pat), jnp.asarray(w))
    np.testing.assert_array_equal(np.asarray(vjp(jnp.asarray(g))[0]), g)
    wt = torch.from_numpy(w).requires_grad_(True)
    tmasks.ste_prune(wt, pat).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(wt.grad.numpy(), g)


def test_masked_mode_runs_through_linear_and_moe():
    """``mode="masked"`` is a mode of the port: ``linear.apply`` is the
    plain product with STE-pruned weights (``prepare`` passes it
    through), and ``moe.apply`` equals JAX's masked MoE, reading the live
    expert weights even where a stale load-time ``pruned`` cache sits."""
    import dataclasses
    sp = tlin.SparsityConfig(pattern=(6, 8), mode="masked")
    rng = np.random.default_rng(1)
    w = torch.from_numpy(_tied(rng, (24, 32)))
    x = torch.from_numpy(rng.standard_normal((5, 32)).astype(np.float32))
    got = tlin.apply({"w": w}, x, sp)
    assert torch.equal(got, x @ tmasks.ste_prune(w, Pattern(6, 8)).T)
    assert tlin.prepare({"w": w}, sp)["w"] is w
    spec = jmoe.MoESpec(d_model=16, d_ff=24, num_experts=4, top_k=2,
                        capacity_factor=16.0)
    p = jax.tree_util.tree_map(np.asarray, jax.jit(
        jmoe.init, static_argnums=1)(jax.random.PRNGKey(4), spec))
    xm = rng.standard_normal((2, 8, 16)).astype(np.float32)
    want = np.asarray(jax.jit(jmoe.apply, static_argnums=(1, 3))(
        p, spec, jnp.asarray(xm),
        jlin.SparsityConfig(pattern=(6, 8), mode="masked")))
    tp = tree.tree_map(lambda a: torch.from_numpy(np.array(a)), p)
    for name in ("w_gate", "w_up", "w_down"):
        tp[name]["pruned"] = torch.zeros_like(tp[name]["w"])  # stale cache
    got = tmoe.apply(tp, tmoe.MoESpec(**dataclasses.asdict(spec)),
                     torch.from_numpy(xm), sp)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


# ------------------------------------------------------------ accumulation
def test_accum_matches_full_batch_and_jax():
    """``accum=2`` against ``accum=1`` (JAX's own test's tolerance) and
    against JAX's jitted ``accum=2`` step, danube masked 6:8."""
    import dataclasses
    from repro.models import model as JM
    from repro.runtime import steps as jsteps
    from repro_torch.convert import params_from_jax

    jcfg = dataclasses.replace(jreg.smoke_config("h2o-danube-3-4b"),
                               sparsity=jlin.SparsityConfig(pattern=(6, 8),
                                                            mode="masked"))
    tcfg = dataclasses.replace(treg.smoke_config("h2o-danube-3-4b"),
                               sparsity=tlin.SparsityConfig(pattern=(6, 8),
                                                            mode="masked"))
    p0 = jax.tree_util.tree_map(np.asarray, jax.jit(
        JM.init, static_argnums=0)(jcfg, jax.random.PRNGKey(0)))
    nb = JSyntheticLM(jcfg, 4, 32, seed=0, host_index=0,
                      host_count=1).batch_at(0)
    jopt = jadamw.AdamWConfig(lr=3e-3)
    jp, jo, jm = jax.jit(lambda p, o, b: jsteps.train_step(
        jcfg, jopt, p, o, b, accum=2))(
        p0, jadamw.init(p0, jopt), {k: jnp.asarray(v) for k, v in nb.items()})
    opt = adamw.AdamWConfig(lr=3e-3)
    out = {}
    for accum in (1, 2):
        tp = params_from_jax(p0, tcfg, device="cpu")
        out[accum] = steps.train_step(
            tcfg, opt, tp, adamw.init(tp, opt),
            {k: torch.from_numpy(np.array(v)) for k, v in nb.items()},
            accum=accum)
    (p1, _, m1), (p2, o2, m2) = out[1], out[2]
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for a, b in zip(tree.leaves(p1), tree.leaves(p2)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=2e-5, rtol=1e-3)
    np.testing.assert_allclose(float(m2["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    for got, want in ((p2, jp), (o2.mu, jo.mu), (o2.nu, jo.nu)):
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, want),
                               tcfg, device="cpu")
        g = torch.cat([x.detach().reshape(-1) for x in tree.leaves(got)])
        w = torch.cat([x.reshape(-1) for x in tree.leaves(want)])
        assert float((g - w).norm() / w.norm()) <= 1e-4


# ---------------------------------------------------------------- pipeline
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "whisper-small",
                                  "qwen2-vl-72b"])
def test_batch_at_bit_equal_to_jax(arch):
    jcfg, tcfg = jreg.smoke_config(arch), treg.smoke_config(arch)
    for host in (0, 1):
        j = JSyntheticLM(jcfg, 8, 32, seed=3, host_index=host, host_count=2)
        t = SyntheticLM(tcfg, 8, 32, seed=3, host_index=host, host_count=2)
        for step in (0, 5):
            want, got = j.batch_at(step), t.batch_at(step)
            assert sorted(want) == sorted(got)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k])
    assert not np.array_equal(t.batch_at(5)["tokens"],
                              SyntheticLM(tcfg, 8, 32, seed=3, host_index=0,
                                          host_count=2).batch_at(5)["tokens"])


def test_host_from_torch_distributed(monkeypatch):
    """Without host_index/host_count the pipeline takes this process's
    rank and the world size from an initialized process group."""
    cfg = treg.smoke_config("h2o-danube-3-4b")
    assert (SyntheticLM(cfg, 8, 32).host_index,
            SyntheticLM(cfg, 8, 32).host_count) == (0, 1)
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    t = SyntheticLM(cfg, 8, 32, seed=3)
    assert (t.host_index, t.host_count, t.host_batch) == (1, 2, 4)
    j = JSyntheticLM(jreg.smoke_config("h2o-danube-3-4b"), 8, 32, seed=3,
                     host_index=1, host_count=2)
    np.testing.assert_array_equal(t.batch_at(2)["tokens"],
                                  j.batch_at(2)["tokens"])


def test_prefetcher_in_order_on_the_device():
    cfg = treg.smoke_config("mamba2-780m")
    pipe = SyntheticLM(cfg, 2, 16, seed=1, host_index=0, host_count=1,
                       device="cpu")
    assert pipe.host_batch == 2
    pf = Prefetcher(pipe, start_step=7)
    try:
        for want in (7, 8, 9):
            step, batch = pf.next()
            assert step == want
            assert isinstance(batch["tokens"], torch.Tensor)
            np.testing.assert_array_equal(batch["tokens"].numpy(),
                                          pipe.batch_at(want)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


# ----------------------------------------------------------------- remat
def test_remat_on_off_bit_equal():
    """6 units as 2 x 3 remat segments, single-level, and no remat: the
    same loss and gradients, bit for bit."""
    import dataclasses
    base = dataclasses.replace(treg.smoke_config("h2o-danube-3-4b"),
                               num_layers=6)
    assert ttrans._remat_split(base.num_units) == (2, 3)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(base, 2, 32, seed=0, host_index=0,
                         host_count=1).batch_at(0).items()}
    params = TM.init(base, torch.Generator().manual_seed(0))
    out = []
    for remat, two in ((True, True), (True, False), (False, False)):
        cfg = dataclasses.replace(base, remat=remat, remat_2level=two)
        leaves = steps.trainable(params)
        loss = TM.loss_fn(params, cfg, batch)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, out[0][1]))


# ------------------------------------------------------------- checkpoints
def _ckpt_tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32),
                  "bf": (torch.randn(4, 5, generator=torch.Generator()
                                     .manual_seed(0)) * 3).bfloat16(),
                  "e4": torch.tensor([1.5, -448.0, 0.0, 0.0625]).to(
                      torch.float8_e4m3fn),
                  "q": torch.tensor([-127, 0, 5, 127], dtype=torch.int8)},
            "s": [torch.zeros(()), None]}


def test_checkpoint_roundtrip_bit_exact(tmp_path):
    t = _ckpt_tree()
    ckpt.save(str(tmp_path), 42, t, extra={"loss": 1.5})
    like = tree.tree_map(torch.zeros_like, t)
    restored, step, extra = ckpt.restore(str(tmp_path), like, device="cpu")
    assert step == 42 and extra["loss"] == 1.5
    assert tree.paths(restored) == tree.paths(t)
    for x, y in zip(tree.leaves(t), tree.leaves(restored)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.dim() else x,
                           y.view(torch.uint8) if y.dim() else y)


def test_checkpoint_atomic_no_partial(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(4)})
    # a stale staging dir (a host killed mid-save) is never picked up
    os.makedirs(tmp_path / "step_00000002.tmp.999", exist_ok=True)
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_async_and_gc(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    t = {"a": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        t["a"].fill_(s)  # the saver holds its own host copy
        saver.save(s, t)
    saver.wait()
    steps_ = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path))
    assert steps_ == [3, 4]
    got, _, _ = ckpt.restore(str(tmp_path), t, step=3, device="cpu")
    assert torch.equal(got["a"], torch.full((4,), 3.0))


def test_checkpoint_structure_mismatch(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(4)})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), {"a": torch.zeros(4),
                                     "b": torch.zeros(2)}, device="cpu")
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), {"a": torch.zeros(5)}, device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {"a": torch.zeros(4)},
                     device="cpu")


# -------------------------------------------------------------------- loop
def _tc(tmp_path=None, steps=12, **kw):
    return train_loop.TrainConfig(
        steps=steps, ckpt_dir=str(tmp_path) if tmp_path else None,
        ckpt_every=5, log_every=100, global_batch=4, seq_len=32, **kw)


def test_loss_decreases_dense():
    cfg = treg.smoke_config("h2o-danube-3-4b")
    out = train_loop.train(cfg, adamw.AdamWConfig(lr=3e-3), _tc(steps=25),
                           device="cpu")
    losses = out["losses"]
    assert len(losses) == 25 and len(out["step_seconds"]) == 25
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-780m"])
def test_loss_decreases_moe_and_ssm(arch):
    cfg = treg.smoke_config(arch)
    out = train_loop.train(cfg, adamw.AdamWConfig(lr=3e-3), _tc(steps=20),
                           device="cpu")
    losses = out["losses"]
    assert all(np.isfinite(losses)), arch
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), arch


def test_checkpoint_resume_exact(tmp_path):
    """Train 10; train 6 (checkpoint at 5 and 6) and resume to 10: the
    same final loss."""
    cfg = treg.smoke_config("minitron-4b")
    opt = adamw.AdamWConfig(lr=1e-3)
    full = train_loop.train(cfg, opt, _tc(tmp_path / "a", steps=10),
                            device="cpu")
    train_loop.train(cfg, opt, _tc(tmp_path / "b", steps=6), device="cpu")
    assert ckpt.latest_step(str(tmp_path / "b")) == 6
    resumed = train_loop.train(cfg, opt, _tc(tmp_path / "b", steps=10),
                               device="cpu")
    assert len(resumed["losses"]) == 4 and resumed["final_step"] == 10
    np.testing.assert_allclose(full["losses"][-1], resumed["losses"][-1],
                               rtol=1e-5)


def test_int8_optimizer_state_trains():
    cfg = treg.smoke_config("h2o-danube-3-4b")
    opt = adamw.AdamWConfig(lr=3e-3, state_dtype="int8")
    out = train_loop.train(cfg, opt, _tc(steps=15), device="cpu")
    assert np.isfinite(out["losses"]).all()
    assert np.mean(out["losses"][-3:]) < np.mean(out["losses"][:3])
    assert all(m.dtype == torch.int8 for m in tree.leaves(out["opt_state"].mu))


def test_straggler_monitor():
    mon = train_loop.StragglerMonitor(z=3.0)
    assert not any(mon.observe(0.1) for _ in range(20))
    assert mon.observe(5.0)  # 50x the EWMA
    assert mon.flagged == 1


def test_launch_train_smoke(tmp_path, capsys):
    out = launch_train.main([
        "--arch", "h2o-danube-3-4b", "--smoke", "--sparse", "6", "8",
        "--steps", "3", "--global-batch", "2", "--seq-len", "16",
        "--opt-state", "int8", "--ckpt-dir", str(tmp_path),
        "--ckpt-every", "2", "--device", "cpu"])
    assert out["final_step"] == 3 and np.isfinite(out["losses"]).all()
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert "median_step_ms" in capsys.readouterr().out


def test_training_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = treg.smoke_config("h2o-danube-3-4b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_loop.train(cfg, adamw.AdamWConfig(), _tc(steps=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "h2o-danube-3-4b", "--smoke"])
    with pytest.raises(TypeError, match="repro_torch.sharding.ctx.Mesh"):
        train_loop.train(cfg, adamw.AdamWConfig(), _tc(steps=1),
                         mesh=object(), device="cpu")
