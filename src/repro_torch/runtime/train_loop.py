"""Training loop with fault tolerance (port of
``repro.runtime.train_loop``, single device).

* checkpoint/restart: periodic async checkpoints and auto-resume from the
  latest atomic checkpoint (step, params, optimizer state; the data
  position is the step, since batches are a function of it);
* preemption handling: SIGTERM/SIGINT raise a flag; the loop takes a final
  synchronous checkpoint and exits cleanly;
* straggler mitigation: a per-step wall-time EWMA z-score monitor logs and
  counts outliers.

The multi-device pieces of the JAX loop (a mesh, sharded parameters,
elastic restore onto another device count) are not ported yet.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime import steps as step_fns


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    straggler_zscore: float = 4.0


class StragglerMonitor:
    """EWMA mean/var of step time; flags steps beyond a z-score threshold."""

    def __init__(self, z: float = 4.0, alpha: float = 0.05):
        self.z, self.alpha = z, alpha
        self.mean = None
        self.var = 0.0
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        if self.mean is None:
            self.mean = dt
            return False
        sd = max(self.var, 1e-12) ** 0.5
        is_straggler = dt > self.mean + self.z * sd and dt > 1.5 * self.mean
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        if is_straggler:
            self.flagged += 1
        return is_straggler


class PreemptionFlag:
    def __init__(self, install: bool = True):
        self.raised = False
        if install:
            try:
                signal.signal(signal.SIGTERM, self._handler)
                signal.signal(signal.SIGINT, self._handler)
            except ValueError:  # not on main thread (tests)
                pass

    def _handler(self, *_):
        self.raised = True


def train(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, tc: TrainConfig,
          mesh=None, hooks: dict[str, Callable] | None = None,
          device=None) -> dict:
    """Runs (or resumes) training on one device (the card unless the
    caller names another); the initial parameters are drawn from a
    ``torch.Generator`` seeded with ``tc.seed`` on that device.  Returns
    the summary {'final_step', 'losses', 'stragglers_flagged', 'params',
    'opt_state', 'step_seconds'} (the last: each step's wall time, the
    loss read back included)."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-device training is not ported yet: ROADMAP A.3's "
            "multi-device pieces (sharding rules, GPipe, gradient "
            "compression, elastic restore)")
    device = resolve_device(device)
    hooks = hooks or {}
    gen = torch.Generator(device=device)
    gen.manual_seed(tc.seed)
    params = M.init(cfg, gen)
    opt_state = adamw.init(params, opt_cfg)
    start_step = 0

    saver = None
    if tc.ckpt_dir:
        saver = ckpt.AsyncCheckpointer(tc.ckpt_dir)
        if ckpt.latest_step(tc.ckpt_dir) is not None:
            state, start_step, _ = ckpt.restore(
                tc.ckpt_dir, {"params": params, "opt": opt_state},
                device=device)
            params, opt_state = state["params"], state["opt"]
            print(f"[train] resumed from step {start_step}")

    pipe = SyntheticLM(cfg, tc.global_batch, tc.seq_len, seed=tc.seed,
                       device=device)
    prefetch = Prefetcher(pipe, start_step=start_step)
    monitor = StragglerMonitor(tc.straggler_zscore)
    preempt = PreemptionFlag(install=bool(tc.ckpt_dir))

    history: list[float] = []
    seconds: list[float] = []
    step = start_step
    try:
        while step < tc.steps:
            t0 = time.time()
            got_step, batch = prefetch.next()
            assert got_step == step, (got_step, step)
            params, opt_state, metrics = step_fns.train_step(
                cfg, opt_cfg, params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            history.append(loss)
            seconds.append(dt)
            if monitor.observe(dt):
                print(f"[train] straggler: step {step} took {dt:.2f}s "
                      f"(ewma {monitor.mean:.2f}s)")
            if tc.log_every and step % tc.log_every == 0:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s")
            step += 1
            if saver and (step % tc.ckpt_every == 0 or step == tc.steps):
                saver.save(step, {"params": params, "opt": opt_state},
                           extra={"loss": loss})
            if "on_step" in hooks:
                hooks["on_step"](step, loss)
            if preempt.raised:
                print("[train] preemption: final checkpoint + clean exit")
                if saver:
                    saver.wait()
                    ckpt.save(tc.ckpt_dir, step,
                              {"params": params, "opt": opt_state},
                              extra={"preempted": True})
                break
    finally:
        prefetch.close()
        if saver:
            saver.wait()

    return {
        "final_step": step,
        "losses": history,
        "stragglers_flagged": monitor.flagged,
        "params": params,
        "opt_state": opt_state,
        "step_seconds": seconds,
    }
