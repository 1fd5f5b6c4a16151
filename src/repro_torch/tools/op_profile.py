"""One dry-run cell, op by op: its largest tensors and its collectives by
call site (the counterpart of ``tools/hlo_profile.py``, as
``launch/op_cost.py`` stands for ``jaxpr_cost.py``).

JAX's profiler reads the compiled HLO of a cell.  The port runs the
cell's step on fake tensors (``launch.dryrun.run_cell``) and counts it
the dry run's own way; this tool only watches that run:

* the tensors: the dry run's :class:`~repro_torch.launch.dryrun.LiveBytes`
  tracker, extended to note each op output of at least 0.3 GB (views
  aside) by dtype and local shape, with the aten op and the port
  function that made it (the innermost frame under ``repro_torch``;
  "backward" where autograd ran it); the 15 largest are printed;
* the collectives: every collective the step runs is tallied by
  ``sharding.ctx.record_collective`` (the dry mesh's and the TP
  context's alike); the tool notes each call's kind, bytes and call site
  (the innermost frame outside ``sharding/ctx.py`` and ``sharding/tp.py``)
  and prints bytes x count by kind and site.  They add up to the
  record's ``collectives``;
* the record's resident and peak bytes and roofline terms.

Every figure is the CPU dry run's count (shapes only, rank 0 of 16x16).

Usage:
  python -m repro_torch.tools.op_profile <arch> <shape> [--moe-pad N]
      [--swa-tile-skip]
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import torch

from repro_torch.launch import dryrun
from repro_torch.sharding import ctx

PORT = Path(__file__).resolve().parents[1]
MIN_BYTES = 3e8
TOP = 15
_MACHINERY = {Path(__file__).resolve(), PORT / "launch" / "dryrun.py",
              PORT / "launch" / "op_cost.py"}
_COLLECTIVES = _MACHINERY | {PORT / "sharding" / "ctx.py",
                             PORT / "sharding" / "tp.py"}


def call_site(skip: set) -> str:
    """The innermost frame of the port outside ``skip``, as
    ``module/file.py:function``; "backward" is added where autograd runs
    the op, "?" stands for no port frame."""
    f = sys._getframe(1)
    while f is not None:
        path = Path(f.f_code.co_filename).resolve()
        if PORT in path.parents and path not in skip:
            site = f"{path.relative_to(PORT)}:{f.f_code.co_name}"
            break
        f = f.f_back
    else:
        site = "?"
    if torch._C._current_autograd_node() is not None:
        site += " (backward)"
    return site


class Profile(dryrun.LiveBytes):
    """The dry run's live-bytes tracker, noting each op output of at
    least ``min_bytes`` that is not a view: ``big[(dtype, shape)] = [bytes,
    op, site, count]`` (the first op and site to make one)."""

    def __init__(self, min_bytes: float = MIN_BYTES):
        super().__init__()
        self.min_bytes = min_bytes
        self.big: dict = {}
        self._op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = func
        return super().__torch_dispatch__(func, types, args, kwargs)

    def outputs(self, outs: list) -> None:
        super().outputs(outs)
        if getattr(self._op, "is_view", False):
            return
        for t in outs:
            n = t.numel() * t.element_size()
            if n >= self.min_bytes:
                key = (str(t.dtype).removeprefix("torch."), tuple(t.shape))
                entry = self.big.setdefault(
                    key, [n, str(self._op), call_site(_MACHINERY), 0])
                entry[3] += 1


@contextlib.contextmanager
def collectives_by_site(sites: dict):
    """Within the block, every ``ctx.record_collective`` call also adds
    its count and bytes to ``sites[(kind, call site)]``."""
    sound = ctx.record_collective

    def record(kind: str, nbytes: int, n: int) -> None:
        c = sites.setdefault((kind, call_site(_COLLECTIVES)), [0, 0])
        c[0] += 1
        c[1] += nbytes
        sound(kind, nbytes, n)

    ctx.record_collective = record
    try:
        yield sites
    finally:
        ctx.record_collective = sound


def profile(arch: str, shape: str, min_bytes: float = MIN_BYTES,
            **levers) -> dict:
    """The cell's record (``dryrun.run_cell`` on 16x16 with ``levers``),
    its tensors of at least ``min_bytes`` largest first, and its
    collectives by (kind, call site) as [count, bytes]."""
    live = Profile(min_bytes)
    with collectives_by_site({}) as sites:
        rec = dryrun.run_cell(arch, shape, False, verbose=False, live=live,
                              **levers)
    tensors = sorted(((n, dt, shp, op, site, count) for (dt, shp), (
        n, op, site, count) in live.big.items()), key=lambda t: -t[0])
    return {"record": rec, "tensors": tensors, "collectives": sites}


def report(p: dict) -> list[str]:
    rec = p["record"]
    head = (f"{rec['arch']} x {rec['shape']} x {rec['mesh']}, levers "
            f"{rec.get('levers') or 'none'} (CPU dry run's counts, rank 0)")
    if rec["status"] != "ok":
        return [head, f"{rec['status']}: {rec.get('reason')}"]
    out = [head, f"resident {rec['resident_bytes'] / 1e9:.3f} GB, peak "
           f"{rec['peak_bytes'] / 1e9:.3f} GB a rank",
           f"--- the {TOP} largest local tensors >= "
           f"{MIN_BYTES / 1e9:.1f} GB (GB, dtype[shape], times made, aten "
           f"op, port function) ---"]
    for n, dt, shp, op, site, count in p["tensors"][:TOP]:
        dims = ",".join(map(str, shp))
        out.append(f"{n / 1e9:8.2f}  {dt}[{dims}]  x{count}  {op}  {site}")
    out.append("--- collectives by kind and call site (GB = bytes x "
               "count) ---")
    for (kind, site), (count, nbytes) in sorted(
            p["collectives"].items(), key=lambda kv: -kv[1][1]):
        out.append(f"{kind:18s} {nbytes / 1e9:9.4f} GB  x{count:<5d} {site}")
    f = rec["roofline"]
    out.append("roofline: " + ", ".join(
        f"{k} {f[k]:.4g}" if isinstance(f[k], float) else f"{k} {f[k]}"
        for k in ("t_compute_s", "t_memory_s", "t_collective_s",
                  "dominant", "useful_flops_ratio")))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--moe-pad", type=int, default=0,
                    help="pad the expert stacks to N")
    ap.add_argument("--swa-tile-skip", action="store_true",
                    help="sliding-window layers visit only their KV chunks")
    args = ap.parse_args(argv)
    p = profile(args.arch, args.shape, moe_pad=args.moe_pad,
                swa_tile_skip=args.swa_tile_skip)
    print("\n".join(report(p)))
    return 0 if p["record"]["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
