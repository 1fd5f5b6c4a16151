"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture x input shape x mesh) cell: run one step as
rank 0 of the production mesh (16x16 = 256 ranks, or 2x16x16 = 512) on
fake CUDA tensors (``FakeTensorMode``: shapes and dtypes, no memory, no
device; the ranks do not exist), and emit a JSON record of what that
rank holds, peaks at, computes and communicates.

JAX lowers and compiles each cell on 512 placeholder host devices and
reads the compiled program's memory and cost analyses.  The port runs
the step itself, so every figure is counted from what it runs:

* train cells run ``steps.train_step(layout=...)`` over a dry
  ``sharding.ctx.Mesh`` (its collectives return tensors of the real
  ones' shapes and count as a real mesh counts), the step's compute
  split along ``model`` as a real mesh's is (``steps.split_degree``,
  every config, the encoder-decoder and a vocabulary t does not divide
  included: the LM head then splits the tokens; ``--seq-par`` sets
  ``cfg.sequence_parallel``); prefill and decode
  cells run the one-shot ``steps.prefill_step`` / ``serve_step`` on the
  tensor-parallel serving shards (``tp.shard_params``) under a dry
  ``tp`` context, the batch split over ``data`` and ``pod``; a decode
  cell whose batch does not divide them (long_500k's batch of 1) runs
  the sequence-sharded ``serve_step(mesh=...)`` over a dry mesh instead,
  each rank holding its S-slice of the cache (``rules.cache_spec``:
  S over every axis).  A serving cell's TP
  degree is the ``model`` axis, or its largest divisor the config
  divides into (``tp.validate``: KV heads, SSM heads, vocab), the rest
  of the axis holding replicas; encoder-decoders serve at tp = 1, as
  the port's serving TP covers decoder stacks only;
* ``resident_bytes``: this rank's params + optimizer state (train) or
  its weight shard + cache (serve; ``cache_bytes`` the cache alone);
* ``peak_bytes``: the most bytes of live tensors (storages, each once)
  at any op boundary of the step, params and state included
  (:class:`LiveBytes`), and whether that fits ``HBM_BYTES`` (an H100
  80GB HBM3);
* FLOPs and bytes from ``launch.op_cost``; the kernels given fake
  tensors record their ``roofline.op_cost`` (``kernels.ops.dry_costs``);
* collectives by kind (``ctx.collectives_by_kind``) and the
  ``analysis.Roofline`` of the step.

Cells the port cannot run are ``status: "skipped"`` with the reason;
none is dropped.  Records go to ``build/repro_torch/dryrun/`` at the
root of the checkout.

The levers are JAX's flags (``--swa-tile-skip``, ``--moe-pad N``,
``--act-quant int8``, ``--seq-par`` and the rest), recorded under
``levers``; ``--all`` hands them to every cell.  JAX's
``--serve-tp-only`` has no counterpart: the serving cells already run
the tensor-parallel layout it selects.

Usage:
  python -m repro_torch.launch.dryrun --arch phi3-medium-14b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod|--single-pod|--both]
  python -m repro_torch.launch.dryrun --all --jobs 4     # subprocess per cell
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import weakref
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_flatten

from repro_torch import tree
from repro_torch.configs import registry, shapes as shp
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import analysis, op_cost
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime import steps
from repro_torch.sharding import ctx, rules, tp

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch" \
    / "dryrun"
HBM_BYTES = 80e9           # H100 80GB HBM3


def fake_device() -> torch.device:
    """The fake tensors' device: cuda:0 where PyTorch has CUDA (an index:
    a bare "cuda" asks the runtime for the current device); the CPU
    elsewhere, since autograd refuses fake CUDA tensors without CUDA (its
    input metadata asks the device for a stream)."""
    return (torch.device("cuda", 0) if torch.cuda.is_available()
            else torch.device("cpu"))


def production_sizes(multi_pod: bool) -> dict:
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


class LiveBytes(op_cost.OpCounter):
    """An op counter that also tracks the bytes of live tensor storages:
    each op's outputs (and every tensor given to ``track``) are counted
    once per storage until the storage is freed; ``peak`` is the most at
    any op boundary.  (One dispatch mode for both: every mode a fake op
    passes through costs about as much again.)"""

    def __init__(self):
        super().__init__()
        self._live: dict[int, int] = {}
        self.now = 0
        self.peak = 0

    def track(self, *trees) -> None:
        for t in op_cost.tensors(tree_flatten(trees)[0]):
            self._add(t)
        self.peak = max(self.peak, self.now)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self.now += self._live[key]
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.now -= self._live.pop(key, 0)

    def outputs(self, outs: list) -> None:
        for t in outs:
            self._add(t)
        self.peak = max(self.peak, self.now)


def fake_params(cfg: ModelConfig, device) -> dict:
    """The whole parameter tree of ``cfg`` as fake tensors on ``device``
    (call inside a ``FakeTensorMode``)."""
    gen = torch.Generator().manual_seed(0)
    return tree.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                               device=device),
                         M.init(cfg, gen))


def _counted(fn, *trees, live: LiveBytes | None = None) -> dict:
    """What ``fn()`` counts under a live-bytes tracker (``live``, a fresh
    :class:`LiveBytes` by default; ``trees`` resident before it) and an
    op counter, with the collective, TP and dry-kernel tallies reset
    first."""
    ctx.reset_counts()
    tp.reset_counts()
    ops.reset_dry_costs()
    live = live if live is not None else LiveBytes()
    live.track(*trees)
    with live:
        fn()
    return {"peak_bytes": live.peak, "counts": dict(live.counts),
                 "collective_count": ctx.collective_count()
                 + tp.collective_count(),
                 "wire_bytes": ctx.wire_bytes(),
                 "collectives": ctx.collectives_by_kind(),
                 "kernels": ops.dry_costs()}


def _meta(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


def train_layout(whole, opt_cfg: adamw.AdamWConfig, mesh: ctx.Mesh):
    """The rules' layout of the whole parameter tree ``whole`` (any
    device, meta included) and AdamW state on ``mesh``, laid out from
    meta tensors."""
    meta = tree.tree_map(_meta, whole)
    opt_meta = adamw.init(meta, opt_cfg)
    return rules.layout(meta, opt_meta, mesh), opt_meta


def resident_bytes(whole, opt_cfg: adamw.AdamWConfig, sizes: dict,
                   rank: int = 0) -> int:
    """Bytes of params + AdamW state rank ``rank`` of a mesh of ``sizes``
    holds in training (its pieces' shapes; nothing is allocated)."""
    mesh = ctx.Mesh.abstract(sizes, rank=rank)
    layout, opt_meta = train_layout(whole, opt_cfg, mesh)
    state = tree.leaves(opt_meta) + tree.leaves(whole)
    return sum(math.prod(rules.local_shape(x.shape, s, mesh))
               * x.element_size() for x, s in zip(state, layout.state))


def train_step_dry(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                   global_batch: int, seq_len: int, sizes: dict | None = None,
                   rank: int = 0, device=None, accum: int = 1,
                   live: LiveBytes | None = None) -> dict:
    """One training step as rank ``rank`` of a dry mesh of ``sizes``
    (None: one device, no layout) on fake tensors: resident and peak
    bytes, op counts, collectives."""
    device = device or fake_device()
    with FakeTensorMode(allow_non_fake_inputs=True):
        whole = fake_params(cfg, device)
        n_params = M.param_count(whole)
        layout = None
        if sizes is None:
            params, opt_state = whole, adamw.init(whole, opt_cfg)
            local_b = global_batch
        else:
            mesh = ctx.Mesh.abstract(sizes, rank=rank, dry=True,
                                     device=device)
            layout, opt_meta = train_layout(whole, opt_cfg, mesh)
            params = rules.shard(whole, layout.params, mesh)
            opt_state = tree.unflatten(opt_meta, [
                torch.zeros(rules.local_shape(x.shape, s, mesh),
                            dtype=x.dtype, device=device)
                for x, s in zip(tree.leaves(opt_meta), layout.opt)])
            dp = math.prod(mesh.axis_size(a) for a in steps.dp_axes(mesh))
            local_b = global_batch // dp
            t = steps.split_degree(cfg, mesh)
        del whole
        batch = {k: torch.zeros((local_b,) + tuple(v.shape[1:]),
                                dtype=v.dtype, device=device)
                 for k, v in shp.input_specs(cfg, shp.ShapeSpec(
                     "cell", seq_len, global_batch, "train")).items()}
        resident = (rules.resident_bytes(params)
                    + rules.resident_bytes(opt_state))
        out = _counted(lambda: steps.train_step(
            cfg, opt_cfg, params, opt_state, batch, accum=accum,
            layout=layout), params, opt_state, batch, live=live)
    extra = {} if sizes is None else {
        "tp": t, "replicas": mesh.axis_size("model") // t}
    return dict(out, resident_bytes=resident, local_batch=local_b,
                param_count=n_params, **extra)


def serve_tp(cfg: ModelConfig, model: int) -> int:
    """The TP degree of a serving cell: the largest divisor of the
    ``model`` axis that ``tp.validate`` accepts (1 for an encoder-
    decoder)."""
    if cfg.is_encoder_decoder:
        return 1
    return tp.degree(cfg, model)


def seq_sharded(shape: shp.ShapeSpec, sizes: dict) -> bool:
    """Whether a decode cell's batch does not divide the data-parallel
    axes (long_500k's batch of 1), so ``rules.cache_spec`` splits its
    cache's S over every axis and the cell runs the sequence-sharded
    serve step."""
    dp = math.prod(s for a, s in sizes.items() if a != "model")
    return shape.kind == "decode" and shape.global_batch % dp != 0


def seq_serve_step_dry(cfg: ModelConfig, shape: shp.ShapeSpec, sizes: dict,
                       rank: int = 0, device=None,
                       live: LiveBytes | None = None) -> dict:
    """One sequence-sharded decode step (``steps.serve_step(mesh=...)``)
    as rank ``rank`` of a dry mesh of ``sizes`` on fake tensors: its
    tensor-parallel shard of the weights, its S-slice of every attention
    cache (built at the local shapes) and its share of the SSM state."""
    device = device or fake_device()
    b = shape.global_batch
    with FakeTensorMode(allow_non_fake_inputs=True):
        mesh = ctx.Mesh.abstract(sizes, rank=rank, dry=True, device=device)
        whole = fake_params(cfg, device)
        n_params = M.param_count(whole)
        params = steps.serve_params(whole, cfg, mesh)
        del whole
        cache, layout = steps.seq_cache(cfg, b, shape.seq_len, mesh,
                                        device=device)
        rows = tree.leaves(cache)[0].shape[0]
        specs = {k: torch.zeros((rows,), dtype=v.dtype, device=device)
                 for k, v in shp.input_specs(cfg, shape).items()}
        resident = rules.resident_bytes(params) + rules.resident_bytes(cache)
        out = _counted(lambda: steps.serve_step(
            cfg, params, specs["token"], cache, specs["kv_len"], mesh=mesh,
            layout=layout), params, cache, specs, live=live)
        t = mesh.axis_size(steps.serve_axis(cfg, mesh))
    seq = layout.seq
    return dict(out, resident_bytes=resident,
                cache_bytes=rules.resident_bytes(cache), local_batch=rows,
                tp=t, replicas=sizes.get("model", 1) // t,
                seq_axes=list(seq.axes) if seq else [],
                seq_len_local=seq.length if seq else None,
                param_count=n_params)


def serve_step_dry(cfg: ModelConfig, shape: shp.ShapeSpec, sizes: dict,
                   rank: int = 0, device=None,
                   live: LiveBytes | None = None) -> dict:
    """One prefill or decode step of ``shape`` as rank ``rank``: its TP
    shard of the weights and its slice of the batch, on fake tensors; a
    cell whose batch does not divide the data-parallel axes runs the
    sequence-sharded step (:func:`seq_serve_step_dry`)."""
    if seq_sharded(shape, sizes):
        return seq_serve_step_dry(cfg, shape, sizes, rank, device, live)
    device = device or fake_device()
    dp = math.prod(s for a, s in sizes.items() if a != "model")
    t = serve_tp(cfg, sizes.get("model", 1))
    b = max(1, shape.global_batch // dp)
    with FakeTensorMode(allow_non_fake_inputs=True):
        whole = fake_params(cfg, device)
        n_params = M.param_count(whole)
        params = tp.shard_params(whole, cfg, rank % t, t)
        del whole
        specs = {k: torch.zeros((b,) + tuple(v.shape[1:]), dtype=v.dtype,
                                device=device)
                 for k, v in shp.input_specs(cfg, shape).items()}
        with tp.activate_dry(t, rank % t):
            if shape.kind == "prefill":
                cache = None
                resident = rules.resident_bytes(params)
                out = _counted(lambda: steps.prefill_step(
                    cfg, shape.seq_len, params, specs), params, specs,
                    live=live)
            else:
                cache = M.make_cache(cfg, b, shape.seq_len, device=device)
                resident = (rules.resident_bytes(params)
                            + rules.resident_bytes(cache))
                out = _counted(lambda: steps.serve_step(
                    cfg, params, specs["token"], cache, specs["kv_len"]),
                    params, cache, specs, live=live)
    extra = {} if cache is None else {
        "cache_bytes": rules.resident_bytes(cache)}
    return dict(out, resident_bytes=resident, local_batch=b, tp=t,
                replicas=sizes.get("model", 1) // t, param_count=n_params,
                **extra)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opt_state_dtype: str = "int8", verbose: bool = True,
             sparse: tuple[int, int] | None = None,
             precision: str | None = None, kv_int8: bool = False,
             no_remat2: bool = False, grad_accum: int = 1,
             seq_par: bool = False, swa_tile_skip: bool = False,
             moe_pad: int = 0, act_quant: str | None = None,
             live: LiveBytes | None = None) -> dict:
    """One cell's record.  The levers (JAX's dry-run flags) map as JAX's
    do: ``swa_tile_skip`` -> ``cfg.swa_tile_skip``, ``moe_pad`` ->
    ``cfg.moe_expert_padding``, ``act_quant`` (the legacy precision axis,
    with ``sparse`` only) -> ``SparsityConfig(act_quant=...)``, which
    ``core.precision.resolve`` maps onto the int8 recipe; the record's
    ``levers`` names every one that differs from its default.  ``live``:
    the step's live-bytes tracker (``tools.op_profile``'s), a fresh
    :class:`LiveBytes` by default."""
    set_levers = levers(
        opt_state=opt_state_dtype, sparse=list(sparse or ()),
        precision=precision, act_quant=act_quant, kv_int8=kv_int8,
        no_remat2=no_remat2, grad_accum=grad_accum, seq_par=seq_par,
        swa_tile_skip=swa_tile_skip, moe_pad=moe_pad)
    cfg = registry.get(arch)
    if swa_tile_skip:
        cfg = dataclasses.replace(cfg, swa_tile_skip=True)
    if moe_pad:
        cfg = dataclasses.replace(cfg, moe_expert_padding=moe_pad)
    if seq_par:
        cfg = dataclasses.replace(cfg, sequence_parallel=True)
    if no_remat2:
        cfg = dataclasses.replace(cfg, remat_2level=False)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if sparse:
        from repro_torch.core.linear import SparsityConfig
        shape_kind = shp.SHAPES[shape_name].kind
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
            pattern=tuple(sparse),
            mode="masked" if shape_kind == "train" else "compressed",
            recipe=precision, act_quant=act_quant))
    shape = shp.SHAPES[shape_name]
    sizes = production_sizes(multi_pod)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "levers": set_levers}
    ok, reason = shp.applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        if verbose:
            print(f"[dryrun] SKIP {arch} x {shape_name}: {reason}")
        return rec

    chips = math.prod(sizes.values())
    t0 = time.time()
    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig(state_dtype=opt_state_dtype)
        cell = train_step_dry(cfg, opt_cfg, shape.global_batch,
                              shape.seq_len, sizes, accum=grad_accum,
                              live=live)
    else:
        cell = serve_step_dry(cfg, shape, sizes, live=live)
    dt = time.time() - t0
    roof = analysis.from_counts(
        cell["counts"], cell["collectives"], chips,
        analysis.model_flops_estimate(cfg, shape),
        analysis.model_bytes_estimate(cfg, shape))
    rec.update(status="ok", seconds=round(dt, 2), chips=chips,
               param_count=cell["param_count"],
               resident_bytes=cell["resident_bytes"],
               peak_bytes=cell["peak_bytes"],
               fits=cell["peak_bytes"] <= HBM_BYTES,
               local_batch=cell["local_batch"],
               flops_per_rank=cell["counts"]["flops"],
               collective_count=cell["collective_count"],
               collectives=cell["collectives"], kernels=cell["kernels"],
               roofline=roof.to_dict())
    for k in ("tp", "replicas", "cache_bytes", "seq_axes",
              "seq_len_local"):
        if k in cell:
            rec[k] = cell[k]
    if shape.kind == "train":
        rec["sequence_parallel"] = cfg.sequence_parallel
    if verbose:
        print(f"[dryrun] OK {arch} x {shape_name} x {rec['mesh']} "
              f"({dt:.1f} s): resident {rec['resident_bytes'] / 1e9:.3f} GB,"
              f" peak {rec['peak_bytes'] / 1e9:.3f} GB "
              f"({'fits' if rec['fits'] else 'does not fit'} in 80 GB); "
              f"flops a rank {rec['flops_per_rank']:.4g}; collectives "
              f"{rec['collective_count']}; roofline: compute "
              f"{roof.t_compute:.4f}s memory {roof.t_memory:.4f}s "
              f"collective {roof.t_collective:.4f}s dominant "
              f"{roof.dominant} useful {roof.useful_flops_ratio:.3f}")
    return rec


# the levers (the dry run's flags, ``--`` + the name with dashes) and
# their defaults: the recorded baseline
LEVER_DEFAULTS = {"opt_state": "int8", "sparse": [], "precision": None,
                  "act_quant": None, "kv_int8": False, "no_remat2": False,
                  "grad_accum": 1, "seq_par": False, "swa_tile_skip": False,
                  "moe_pad": 0}


def levers(**values) -> dict:
    """The levers among ``values`` that differ from their defaults."""
    return {k: v for k, v in values.items() if v != LEVER_DEFAULTS[k]}


def lever_flags(set_levers: dict) -> list[str]:
    """The command-line flags of ``set_levers`` (a record's ``levers``;
    ``--all`` hands them to each cell's process)."""
    out = []
    for name, v in set_levers.items():
        flag = "--" + name.replace("_", "-")
        out += [flag] if v is True else [flag, *map(
            str, v if isinstance(v, list) else [v])]
    return out


def all_cells(meshes: list[bool]):
    for arch in registry.ARCH_IDS:
        for shape_name in shp.SHAPES:
            for multi in meshes:
                yield arch, shape_name, multi


def _cell_path(arch: str, shape_name: str, multi: bool) -> Path:
    return RESULTS_DIR / f"{arch}__{shape_name}__{'mp' if multi else 'sp'}.json"


def _summary(rec: dict) -> dict:
    keys = ("arch", "shape", "mesh", "levers", "status", "reason", "tp",
            "sequence_parallel",
            "resident_bytes", "peak_bytes", "fits", "flops_per_rank",
            "collective_count", "seconds")
    return {k: rec[k] for k in keys if k in rec}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(registry.ARCH_IDS))
    ap.add_argument("--shape", choices=list(shp.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--both", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt-state", default="int8", choices=["int8", "float32"])
    ap.add_argument("--json", help="write the JSON record to this path")
    ap.add_argument("--jobs", type=int, default=1,
                    help="subprocesses for --all")
    ap.add_argument("--sparse", nargs=2, type=int, metavar=("Z", "L"),
                    default=[],
                    help="SlideSparse weights: masked (STE) in train cells, "
                         "compressed in serve cells")
    ap.add_argument("--precision", default=None,
                    choices=["none", "int8", "fp8", "w4", "fp8w4"],
                    help="precision recipe for --sparse")
    ap.add_argument("--no-remat2", action="store_true",
                    help="single-level remat (one fewer forward pass)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache (halves decode cache bytes)")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches per optimizer step")
    ap.add_argument("--seq-par", action="store_true",
                    help="sequence parallelism (Megatron-SP) in train "
                         "cells: the residual stream split along S over "
                         "the model axis' split")
    ap.add_argument("--swa-tile-skip", action="store_true",
                    help="sliding-window layers visit only the KV chunks "
                         "of their window (AttnSpec.tile_skip)")
    ap.add_argument("--moe-pad", type=int, default=0,
                    help="pad the expert stacks to N (expert parallelism "
                         "where E does not divide the axis)")
    ap.add_argument("--act-quant", choices=["int8"], default=None,
                    help="legacy precision flag for --sparse; maps onto "
                         "the int8 recipe")
    args = ap.parse_args(argv)

    meshes = [True] if args.multi_pod else [False]
    if args.both:
        meshes = [False, True]

    if args.all:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        cells = list(all_cells(meshes))
        flags = lever_flags(levers(**{k: getattr(args, k)
                                      for k in LEVER_DEFAULTS}))
        failed, running = [], []
        for arch, shape_name, multi in cells:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name,
                   "--multi-pod" if multi else "--single-pod", "--json",
                   str(_cell_path(arch, shape_name, multi))] + flags
            while len(running) >= max(1, args.jobs):
                running = _reap(running, failed)
            print("[dryrun] launch:", " ".join(cmd[3:]), flush=True)
            running.append((subprocess.Popen(cmd), cmd))
        while running:
            running = _reap(running, failed)
        for arch, shape_name, multi in cells:
            path = _cell_path(arch, shape_name, multi)
            if path.exists():
                print("[dryrun] " + json.dumps(_summary(
                    json.loads(path.read_text()))))
        print(f"[dryrun] done: {len(cells) - len(failed)}/{len(cells)} ok")
        for cmd in failed:
            print("[dryrun] FAILED:", " ".join(cmd))
        sys.exit(1 if failed else 0)

    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    rec = run_cell(args.arch, args.shape, multi_pod=meshes[-1],
                   opt_state_dtype=args.opt_state,
                   sparse=tuple(args.sparse) if args.sparse else None,
                   precision=args.precision, kv_int8=args.kv_int8,
                   no_remat2=args.no_remat2, grad_accum=args.grad_accum,
                   seq_par=args.seq_par, swa_tile_skip=args.swa_tile_skip,
                   moe_pad=args.moe_pad, act_quant=args.act_quant)
    path = Path(args.json) if args.json else _cell_path(
        args.arch, args.shape, meshes[-1])
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=2))
    print("[dryrun] " + json.dumps(_summary(rec)))
    sys.exit(0 if rec["status"] in ("ok", "skipped") else 1)


def _reap(running, failed):
    still = []
    for proc, cmd in running:
        ret = proc.poll()
        if ret is None:
            still.append((proc, cmd))
        elif ret != 0:
            failed.append(cmd)
    if len(still) == len(running):
        time.sleep(0.5)
    return still


if __name__ == "__main__":
    main()
