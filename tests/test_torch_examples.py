"""The port's examples (``repro_torch.launch.quickstart``,
``.sparsity_sweep``, ``.train_tiny_lm``) held against ``examples/``, on
the CPU.

* ``quickstart.run`` on JAX's ``jax.random`` w and x (carried as numpy)
  gives ``examples/quickstart.py``'s printed figures: bytes equal, the
  max errors within QUICK_ATOL, the int8 mean relative error within 1e-4;
  its printed family, shapes and storage lines are JAX's, character for
  character.
* The sweep's configs (every regime's) and ``hundred_m_config`` (danube
  and granite-moe, dense and 6:8) equal JAX's field for field; the tiny
  LM's parameter count equals JAX's, counted with ``jax.eval_shape``.
* The sweep's int8 and w4 eval losses on params carried by
  ``params_from_jax`` match JAX's unjitted ``loss_fn`` for dense, 6:8 and
  2:4 within EVAL_RTOL, and ``eval_loss`` hands ``loss_fn`` JAX's
  quantized config field for field and JAX's held-out batch bit for bit.
* Each ``main`` runs with ``--device cpu`` at a few steps, the tiny LM
  (shrunk) resumes from its own checkpoint, and without ``--device``
  each entry point raises where CUDA is missing.
"""
import contextlib
import dataclasses
import io
import math
import pathlib
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLM as JSynthetic
from repro.models import model as JM
from repro.runtime import train_loop as jtrain_loop

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.convert import params_from_jax
from repro_torch.launch import quickstart, sparsity_sweep, train_tiny_lm

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
# max|slided - dense| and max|compressed - dense| are fp32 rounding of
# 1024-term sums with |y| < 8 (a few ulps of 8 = 4.8e-7 each): JAX reads
# 2.38e-6 and 0.0, the port on the CPU 0.0 and 0.0
QUICK_ATOL = 1e-5
# a one-ulp difference ahead of a per-token quantizer moves an activation
# by a whole int8 step: JAX's own jitted and op-by-op losses of one dense
# w4 model here differ by 8.6e-4 (1.1e-4 of the loss); the port reads
# within 7.2e-4 of JAX's op-by-op loss.  The loss alone cannot hold the
# eval's wiring: with the recipe left out, the port's loss on these
# params lies 1.1e-4 / 8.8e-4 / 2.2e-3 from JAX's int8 loss (dense, 6:8,
# 2:4; 0.04x-0.91x of this limit), as per-token int8 error at init
# averages out over the tokens (w4 where int8 is asked: 6.3x-15.5x).  So
# the test also catches the config and batch ``loss_fn`` is handed.
EVAL_RTOL = 3e-4
EVAL_BATCH, EVAL_SEQ = 2, 32


def _run_example(name, argv) -> str:
    """``examples/<name>`` run as ``__main__`` with ``argv``; its stdout."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(buf):
        mp.setattr(sys, "argv", [name] + argv)
        runpy.run_path(str(EXAMPLES / name), run_name="__main__")
    return buf.getvalue()


def _figure(out: str, prefix: str) -> str:
    return next(line for line in out.splitlines()
                if line.startswith(prefix))[len(prefix):].strip()


@pytest.fixture(scope="module")
def jax_quickstart():
    """JAX's example's stdout and its inputs, as numpy."""
    out = _run_example("quickstart.py", [])
    w = jax.random.normal(jax.random.PRNGKey(0), (512, 1024)) * 1024 ** -0.5
    x = jax.random.normal(jax.random.PRNGKey(1), (64, 1024))
    return out, np.array(w), np.array(x)


def test_quickstart_gives_jax_figures(jax_quickstart):
    out, w, x = jax_quickstart
    got = quickstart.run(torch.from_numpy(w), torch.from_numpy(x), "cpu")
    assert _figure(out, "storage:") == (
        f"dense {got['dense_bytes']} B -> compressed "
        f"{got['compressed_bytes']} B (0.844x)")
    assert (got["dense_bytes"], got["compressed_bytes"]) == (1048576, 884736)
    for prefix, key in (("max |slided - dense|   :", "slided_err"),
                        ("max |compressed - dense|:", "compressed_err")):
        assert abs(got[key] - float(_figure(out, prefix))) <= QUICK_ATOL
    assert got["compressed_err"] == 0.0   # B1's plain version: exact
    assert abs(got["int8_rel_err"]
               - float(_figure(out, "int8 pipeline mean rel err:"))) <= 1e-4
    assert got["slided_shape"] == (512, 1536) and got["gamma"] == 1.5


def test_quickstart_main_prints_jax_lines(jax_quickstart, capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    want = jax_quickstart[0].splitlines()
    # the family table, shapes and storage lines do not depend on the draw
    same = [line for line in want if "density=" in line
            or line.startswith(("weights:", "storage:", "==="))]
    assert len(same) == 9 and all(line in out for line in same)
    assert "device: cpu" in out


@pytest.fixture(scope="module")
def jax_sweep_configs() -> dict:
    """The config ``examples/sparsity_sweep.py`` trains for each regime,
    caught at ``train_loop.train``: {pattern: config}."""
    seen = {}

    def fake_train(cfg, opt_cfg, tc):
        seen[cfg.sparsity.pattern] = cfg
        return {"losses": [0.0], "params": None}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain_loop, "train", fake_train)
        _run_example("sparsity_sweep.py", ["--steps", "1"])
    return seen


def _fields(cfg) -> dict:
    """Every field, the sparsity config's too, but for JAX's Pallas
    selector ``use_pallas`` (None here), which the port's dispatch by
    device has no use for."""
    out = dataclasses.asdict(cfg)
    assert out["sparsity"].pop("use_pallas", None) is None
    return out


def test_sweep_configs_match_jax(jax_sweep_configs):
    want = jax_sweep_configs
    base = sparsity_sweep.base_config()
    assert set(want) == set(sparsity_sweep.REGIMES.values())
    for pat in sparsity_sweep.REGIMES.values():
        assert _fields(sparsity_sweep.regime_config(base, pat)) == \
            _fields(want[pat])


@pytest.mark.parametrize("sparse", [None, (6, 8)])
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "granite-moe-3b-a800m"])
def test_hundred_m_config_and_count_match_jax(arch, sparse):
    jfn = runpy.run_path(str(EXAMPLES / "train_tiny_lm.py"))[
        "hundred_m_config"]
    jcfg = jfn(arch, sparse)
    tcfg = train_tiny_lm.hundred_m_config(arch, sparse)
    assert _fields(tcfg) == _fields(jcfg)
    shapes = jax.eval_shape(lambda: JM.init(jcfg, jax.random.PRNGKey(0)))
    want = sum(math.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes))
    assert train_tiny_lm.param_count(tcfg) == want


@pytest.fixture(scope="module")
def regime_params(jax_sweep_configs):
    """JAX ``init`` params of each checked regime's config, as numpy."""
    out = {}
    for i, name in enumerate(("dense", "6:8", "2:4")):
        jcfg = jax_sweep_configs[sparsity_sweep.REGIMES[name]]
        tree = jax.tree_util.tree_map(
            np.asarray, JM.init(jcfg, jax.random.PRNGKey(10 + i)))
        out[name] = (jcfg, tree)
    return out


@pytest.mark.parametrize("recipe", ["int8", "w4"])
@pytest.mark.parametrize("regime", ["dense", "6:8", "2:4"])
def test_sweep_eval_loss_matches_jax(regime_params, regime, recipe,
                                     monkeypatch):
    jcfg, tree = regime_params[regime]
    qcfg = dataclasses.replace(jcfg, sparsity=dataclasses.replace(
        jcfg.sparsity, act_quant=None, recipe=recipe))
    batch = JSynthetic(qcfg, EVAL_BATCH, EVAL_SEQ,
                       seed=sparsity_sweep.EVAL_SEED).batch_at(0)
    want = float(JM.loss_fn(tree, qcfg, batch))   # unjitted
    tcfg = sparsity_sweep.regime_config(sparsity_sweep.base_config(),
                                        sparsity_sweep.REGIMES[regime])
    handed = []
    loss_fn = sparsity_sweep.M.loss_fn

    def spy(params, cfg, b):
        handed.append((cfg, b))
        return loss_fn(params, cfg, b)
    monkeypatch.setattr(sparsity_sweep.M, "loss_fn", spy)
    got = sparsity_sweep.eval_loss(params_from_jax(tree, tcfg, "cpu"), tcfg,
                                   recipe, EVAL_BATCH, EVAL_SEQ, "cpu")
    [(cfg, b)] = handed
    assert _fields(cfg) == _fields(qcfg)
    assert sorted(b) == sorted(batch)
    for k in batch:
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(batch[k]))
    assert abs(got - want) <= EVAL_RTOL * abs(want), (got, want)


def test_sweep_main_on_the_cpu(capsys):
    out = sparsity_sweep.main(["--steps", "2", "--batch", "2", "--seq", "16",
                               "--precision", "int8", "--device", "cpu"])
    assert list(out) == list(sparsity_sweep.REGIMES)
    for losses, final, qloss in out.values():
        assert len(losses) == 2 and np.isfinite(losses).all()
        assert final == losses[-1] and np.isfinite(qloss)
    text = capsys.readouterr().out
    assert "int8-eval-loss" in text and "[sweep]    2:4" in text


def _shrunk(monkeypatch):
    """``hundred_m_config`` at a CPU test's size (same family, flags and
    sparsity; narrow and two layers deep)."""
    full = train_tiny_lm.hundred_m_config
    monkeypatch.setattr(train_tiny_lm, "hundred_m_config",
                        lambda arch, sparse=None: dataclasses.replace(
                            full(arch, sparse), d_model=64, num_heads=4,
                            num_kv_heads=2, head_dim=16, d_ff=128,
                            vocab_size=512, num_layers=2))


def test_tiny_lm_main_resumes_on_the_cpu(monkeypatch, tmp_path, capsys):
    _shrunk(monkeypatch)
    args = ["--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "1", "--int8-opt", "--sparse", "6", "8",
            "--device", "cpu"]
    first = train_tiny_lm.main(["--steps", "3"] + args)
    assert first["final_step"] == 3 and ckpt.latest_step(str(tmp_path)) == 3
    text = capsys.readouterr().out
    assert "sparsity=(6, 8) mode=masked" in text and "-> " in text
    second = train_tiny_lm.main(["--steps", "5"] + args)
    text = capsys.readouterr().out
    assert "[train] resumed from step 3" in text
    assert second["final_step"] == 5 and len(second["losses"]) == 2
    assert np.isfinite(first["losses"] + second["losses"]).all()


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.run(*quickstart.draw("cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sparsity_sweep.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_tiny_lm.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
