"""Deterministic synthetic token pipeline with per-host sharding and
prefetch (port of ``repro.data.pipeline``).

* Deterministic: a batch is a pure function of (seed, step, host), built
  in numpy exactly as the JAX package builds it, so a resumed run (or a
  re-scheduled host) regenerates the batches it owes, bit for bit.
* Per-host sharding: each host builds only its slice of the global
  batch; the host index and count come from ``torch.distributed`` when a
  process group is initialized, and are 0 and 1 otherwise.
* Background prefetch: a thread builds the next batches and copies them
  to the device while the current step runs.

The stream is Zipf unigrams with repeated copy-motifs, so a small LM has
learnable signal and its loss curve means something.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


def _host() -> tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class SyntheticLM:
    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0, host_index: int | None = None,
                 host_count: int | None = None, device=None):
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        rank, world = _host()
        self.host_index = rank if host_index is None else host_index
        self.host_count = world if host_count is None else host_count
        if global_batch % self.host_count:
            raise ValueError("global batch must divide across hosts")
        self.host_batch = global_batch // self.host_count
        self.device = device  # resolved when a batch goes to the device
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._zipf = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Pure function of (seed, step, host): the batch this host owes."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index]))
        b, s, v = self.host_batch, self.seq_len, self.cfg.vocab_size
        toks = rng.choice(v, size=(b, s + 1), p=self._zipf).astype(np.int32)
        # copy-motifs: spans repeated later in the sequence give the model
        # an in-context signal to learn
        motif = max(4, s // 16)
        for row in range(b):
            src = rng.integers(0, s // 2)
            dst = rng.integers(s // 2, s - motif + 1)
            toks[row, dst:dst + motif] = toks[row, src:src + motif]
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.frontend == "audio":
            batch["audio_embeds"] = rng.standard_normal(
                (b, self.cfg.max_source_positions, self.cfg.d_model)
            ).astype(np.float32)
        elif self.cfg.frontend == "vision":
            batch["vision_embeds"] = rng.standard_normal(
                (b, min(256, s), self.cfg.d_model)).astype(np.float32)
        return batch

    def device_batch_at(self, step: int) -> dict[str, torch.Tensor]:
        """``batch_at(step)`` as tensors on the pipeline's device (the card
        unless the pipeline was given another)."""
        device = resolve_device(self.device)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in self.batch_at(step).items()}


class Prefetcher:
    """Double-buffered background prefetch: a thread builds the batches
    from ``start_step`` on and puts them on the device, ``depth`` ahead of
    the consumer."""

    def __init__(self, pipeline: SyntheticLM, start_step: int = 0,
                 depth: int = 2):
        self.pipeline = pipeline
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        try:
            while not self._stop.is_set():
                batch = self.pipeline.device_batch_at(step)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1
        except Exception as e:  # raised to the consumer by next()
            self._error = e
            self._stop.set()

    def next(self):
        """(step, batch) of the next step in order."""
        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if self._error is not None:
                    raise self._error
                if not self._thread.is_alive():
                    raise RuntimeError("prefetch thread stopped")

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
