"""Fault-tolerant checkpointing: atomic publish, async save, auto-resume
(port of ``repro.checkpoint.checkpointer``).

Layout: ``<dir>/step_<N>/{arrays.npz, manifest.json}``, N zero-padded to
8 digits; a checkpoint becomes visible only when its directory is
renamed from a ``.tmp.<pid>`` staging name, so a host killed mid-save
never leaves a half checkpoint that ``latest_step`` would pick up.
Leaves are stored as host numpy arrays in the tree's visiting order
(``tree.leaves``).  numpy has no bfloat16 or float8_e4m3fn: such leaves
are stored as their int16 / int8 bit patterns, with the torch dtype of
every leaf in the manifest, so a restore is bit-exact.

A sharded tree (one rank's pieces, given the leaves' specs and the mesh)
is saved as its whole, logical arrays: every rank gathers, rank 0
writes, in the same format.  ``restore`` given specs and a mesh reads
the host arrays and cuts this rank's pieces for that mesh, so a
single-device checkpoint restores onto a mesh, a sharded one onto one
device, and either onto a mesh of another shape.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_util
from repro_torch.sharding import rules

# torch dtypes numpy cannot hold, stored as integers of the same width
_BITCAST = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.int8}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype in _BITCAST:
        x = x.view(_BITCAST[x.dtype])
    return x.numpy()


def _whole_on_host(tree, specs, mesh) -> list:
    """The tree's leaves as whole host tensors: gathered over the mesh
    when it is sharded (every rank of the mesh calls this)."""
    if mesh is None:
        return [x.detach().to("cpu", copy=True)
                for x in tree_util.leaves(tree)]
    return [rules.gather_leaf(x.detach(), s, mesh).to("cpu", copy=True)
            for x, s in zip(tree_util.leaves(tree), specs)]


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None,
         specs: list | None = None, mesh=None) -> str:
    """Synchronous atomic checkpoint of a tree of tensors.  Returns the
    published path.  Given ``specs`` (one per leaf) and the ``mesh``, the
    tree holds this rank's pieces: every rank calls, rank 0 writes the
    whole arrays, and the call returns on every rank once they are
    published."""
    if mesh is not None:
        host = tree_util.unflatten(tree, _whole_on_host(tree, specs, mesh))
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if mesh.rank == 0:
            save(ckpt_dir, step, host, extra)
        mesh.barrier()
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    leaves = tree_util.leaves(tree)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)})
    manifest = {
        "step": step,
        "num_leaves": len(leaves),
        "dtypes": [_dtype_name(x.dtype) for x in leaves],
        "treedef": tree_util.describe(tree),
        "time": time.time(),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """The newest published step under ``ckpt_dir`` (staging directories
    and directories without a manifest ignored), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") \
                and ".tmp." not in name:
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, like_tree, step: int | None = None, device=None,
            specs: list | None = None, mesh=None):
    """Restore into the structure of ``like_tree`` (its leaves' shapes and
    dtypes), on ``device`` (the card unless the caller names another).
    Returns (tree, step, extra).  Raises ValueError when the leaf count
    or a leaf's shape differs.  Given ``specs`` (one per leaf) and a
    ``mesh``, ``like_tree`` holds pieces: each leaf is this rank's piece
    of the stored whole array, on ``mesh.device``."""
    if mesh is not None:
        device = mesh.device
    device = resolve_device(device)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = tree_util.leaves(like_tree)
    if manifest["num_leaves"] != len(leaves):
        raise ValueError("checkpoint/model structure mismatch: "
                         f"{manifest['num_leaves']} vs {len(leaves)} leaves")
    restored = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (ref, name) in enumerate(zip(leaves, manifest["dtypes"])):
            arr = data[f"leaf_{i}"]
            want = tuple(ref.shape) if mesh is None else \
                rules.global_shape(ref.shape, specs[i], mesh)
            if tuple(arr.shape) != want:
                raise ValueError(f"leaf {i} shape mismatch: {arr.shape} vs "
                                 f"{want}")
            t = torch.from_numpy(arr)
            stored = getattr(torch, name)
            if stored in _BITCAST:
                t = t.view(stored)
            if mesh is not None:
                t = rules.cut(t, specs[i], mesh)
            restored.append(t.to(device=device, dtype=ref.dtype,
                                 copy=True).contiguous())
    return tree_util.unflatten(like_tree, restored), step, manifest["extra"]


class AsyncCheckpointer:
    """Background-thread checkpointing: the step loop hands off host
    copies and keeps training; ``wait()`` joins before exit or
    preemption and raises what the last save raised.  Keeps the newest
    ``keep`` checkpoints."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree, extra: dict | None = None,
             specs: list | None = None, mesh=None):
        """Given ``specs`` and the ``mesh``, ``tree`` holds this rank's
        pieces: every rank gathers the whole arrays (on the caller's
        thread: collectives), rank 0 writes them."""
        self.wait()
        # the device -> host copies happen on the caller's thread, before
        # the next step writes the parameters in place; file IO happens in
        # the background
        host = tree_util.unflatten(tree, _whole_on_host(tree, specs, mesh))
        if mesh is not None and mesh.rank != 0:
            return

        def work():
            try:
                save(self.ckpt_dir, step, host, extra)
                self._gc()
            except Exception as e:  # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.ckpt_dir)
            if n.startswith("step_") and ".tmp" not in n)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
