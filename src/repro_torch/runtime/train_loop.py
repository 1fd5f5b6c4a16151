"""Training loop with fault tolerance (port of
``repro.runtime.train_loop``), on one device or over a mesh of ranks.

* checkpoint/restart: periodic async checkpoints and auto-resume from the
  latest atomic checkpoint (step, params, optimizer state; the data
  position is the step, since batches are a function of it);
* preemption handling: SIGTERM/SIGINT raise a flag; the loop takes a final
  synchronous checkpoint and exits cleanly;
* straggler mitigation: a per-step wall-time EWMA z-score monitor logs and
  counts outliers.

Given a ``sharding.ctx.Mesh``, every rank of the mesh calls ``train``:
each draws the same full init from ``tc.seed`` on its device and keeps
its pieces by ``sharding.rules`` (as JAX ``device_put``s a replicated
init onto ``params_shardings``), takes its ``batch_spec`` slice of the
global batch, and runs the sharded step (``steps.train_step`` given the
layout), which splits its compute along the mesh's ``model`` axis
(``cfg.sequence_parallel`` its one knob).  Checkpoints hold the whole
arrays, so a run resumes onto any mesh, or onto one device.  Rank 0
logs.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import torch

from repro_torch import resolve_device, tree
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime import steps as step_fns
from repro_torch.sharding import ctx, rules


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
        self.installed = install
        if install:
            try:
                signal.signal(signal.SIGTERM, self._handler)
                signal.signal(signal.SIGINT, self._handler)
            except ValueError:  # not on main thread (tests)
                pass

    def _handler(self, *_):
        self.raised = True


def _sharded_init(params, opt_cfg: adamw.AdamWConfig, mesh: ctx.Mesh):
    """(this rank's parameter pieces, its zero optimizer-state pieces, the
    layout) from the whole init; the state is laid out from meta tensors,
    so no whole moment is allocated."""
    meta = tree.tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                               device="meta"), params)
    opt_meta = adamw.init(meta, opt_cfg)
    layout = rules.layout(meta, opt_meta, mesh)
    opt_state = tree.unflatten(opt_meta, [
        torch.zeros(rules.local_shape(x.shape, s, mesh), dtype=x.dtype,
                    device=mesh.device)
        for x, s in zip(tree.leaves(opt_meta), layout.opt)])
    return rules.shard(params, layout.params, mesh), opt_state, layout


def train(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, tc: TrainConfig,
          mesh=None, hooks: dict[str, Callable] | None = None,
          device=None) -> dict:
    """Runs (or resumes) training on one device (the card unless the
    caller names another), or, given a ``sharding.ctx.Mesh``, over its
    ranks (on ``mesh.device``; every rank calls); the initial parameters
    are drawn from a ``torch.Generator`` seeded with ``tc.seed`` on that
    device.  Returns the summary {'final_step', 'losses',
    'stragglers_flagged', 'params', 'opt_state', 'step_seconds',
    'layout'} (``step_seconds``: each step's wall time, the loss read
    back included; over a mesh ``params`` and ``opt_state`` are the
    rank's pieces and ``layout`` their ``rules.Layout``, else None)."""
    layout = None
    if mesh is not None:
        if not isinstance(mesh, ctx.Mesh):
            raise TypeError("train(mesh=...) takes a "
                            "repro_torch.sharding.ctx.Mesh, not "
                            f"{type(mesh).__name__}")
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        device = mesh.device
    device = resolve_device(device)
    lead = mesh is None or mesh.rank == 0
    hooks = hooks or {}
    gen = torch.Generator(device=device)
    gen.manual_seed(tc.seed)
    params = M.init(cfg, gen)
    if mesh is None:
        opt_state = adamw.init(params, opt_cfg)
    else:
        params, opt_state, layout = _sharded_init(params, opt_cfg, mesh)
    specs = None if layout is None else layout.state
    start_step = 0

    saver = None
    if tc.ckpt_dir:
        saver = ckpt.AsyncCheckpointer(tc.ckpt_dir)
        if ckpt.latest_step(tc.ckpt_dir) is not None:
            state, start_step, _ = ckpt.restore(
                tc.ckpt_dir, {"params": params, "opt": opt_state},
                device=device, specs=specs, mesh=mesh)
            params, opt_state = state["params"], state["opt"]
            if lead:
                print(f"[train] resumed from step {start_step}")

    # over a mesh every rank builds the global batch (one host's) and
    # takes its batch_spec slice
    hosts = {} if mesh is None else {"host_index": 0, "host_count": 1}
    pipe = SyntheticLM(cfg, tc.global_batch, tc.seq_len, seed=tc.seed,
                       device=device, **hosts)
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
            if mesh is not None:
                batch = {k: rules.cut(v, rules.batch_spec(v, mesh), mesh)
                         for k, v in batch.items()}
            params, opt_state, metrics = step_fns.train_step(
                cfg, opt_cfg, params, opt_state, batch, layout=layout)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            history.append(loss)
            seconds.append(dt)
            if monitor.observe(dt) and lead:
                print(f"[train] straggler: step {step} took {dt:.2f}s "
                      f"(ewma {monitor.mean:.2f}s)")
            if tc.log_every and step % tc.log_every == 0 and lead:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s")
            step += 1
            if saver and (step % tc.ckpt_every == 0 or step == tc.steps):
                saver.save(step, {"params": params, "opt": opt_state},
                           extra={"loss": loss}, specs=specs, mesh=mesh)
            if "on_step" in hooks:
                hooks["on_step"](step, loss)
            if _preempted(preempt, mesh):
                if lead:
                    print("[train] preemption: final checkpoint + clean exit")
                if saver:
                    saver.wait()
                    ckpt.save(tc.ckpt_dir, step,
                              {"params": params, "opt": opt_state},
                              extra={"preempted": True}, specs=specs,
                              mesh=mesh)
                break
    finally:
        prefetch.close()
        if saver:
            saver.wait()
    if saver and mesh is not None:
        mesh.barrier()  # rank 0's last checkpoint is published

    return {
        "final_step": step,
        "losses": history,
        "stragglers_flagged": monitor.flagged,
        "params": params,
        "opt_state": opt_state,
        "step_seconds": seconds,
        "layout": layout,
    }


def _preempted(flag: PreemptionFlag, mesh) -> bool:
    """Whether to stop here: over a mesh, when any rank got the signal
    (a MAX over the ranks, so they stop at the same step)."""
    if mesh is None or not flag.installed:
        return flag.raised
    raised = torch.tensor([float(flag.raised)], device=mesh.device)
    return bool(mesh.all_reduce(raised, mesh.axis_names, "max").item())
