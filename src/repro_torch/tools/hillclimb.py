"""Run a variant of one dry-run cell and diff it against its baseline
(port of ``tools/hillclimb.py``).

The variant is the dry run of one 16x16 cell with extra flags (the
levers: ``--swa-tile-skip``, ``--moe-pad N``, ``--seq-par``, ...), in a
process of its own; its record goes to
``build/repro_torch/hillclimb/<arch>__<shape>__<tag>.json`` and is held
against ``build/repro_torch/dryrun/<arch>__<shape>__sp.json`` (the
``--all`` record): the roofline terms, the peak bytes, the FLOPs and the
collectives a rank, each as baseline -> variant (ratio).  Every figure
is the CPU dry run's count (shapes only).

Usage:
  python -m repro_torch.tools.hillclimb <arch> <shape> <tag> [dryrun flags...]
  e.g. python -m repro_torch.tools.hillclimb h2o-danube-3-4b train_4k \\
      skip --swa-tile-skip
Exits 1 when the variant's dry run fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.launch import dryrun

BASE_DIR = dryrun.RESULTS_DIR
OUT_DIR = dryrun.RESULTS_DIR.parent / "hillclimb"
TERMS = ("t_compute_s", "t_memory_s", "t_collective_s", "dominant",
         "useful_flops_ratio")
COUNTS = ("peak_bytes", "flops_per_rank", "collective_count")


def variant_path(arch: str, shape: str, tag: str) -> Path:
    return OUT_DIR / f"{arch}__{shape}__{tag}.json"


def base_path(arch: str, shape: str) -> Path:
    return BASE_DIR / f"{arch}__{shape}__sp.json"


def run_variant(arch: str, shape: str, out: Path,
                flags: list[str]) -> subprocess.CompletedProcess:
    """The variant's dry run, in a process of its own."""
    src = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p)}
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--single-pod", "--json", str(out), *flags]
    return subprocess.run(cmd, env=env, capture_output=True, text=True)


def values(rec: dict) -> dict:
    """The compared figures of one record: its roofline terms and
    counts."""
    out = {k: rec["roofline"][k] for k in TERMS}
    out.update({k: rec[k] for k in COUNTS})
    return out


def diff(base: dict, new: dict) -> dict:
    """{figure: (baseline, variant, variant / baseline or None)}; the
    ratio is None for ``dominant`` and for a zero baseline."""
    b, n = values(base), values(new)
    return {k: (b[k], n[k], n[k] / b[k]
                if k != "dominant" and b[k] else None) for k in b}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 3:
        print(__doc__)
        return 2
    arch, shape, tag, flags = argv[0], argv[1], argv[2], argv[3:]
    out = variant_path(arch, shape, tag)
    out.parent.mkdir(parents=True, exist_ok=True)
    r = run_variant(arch, shape, out, flags)
    if r.returncode or not out.exists():
        print(r.stdout[-3000:])
        print(r.stderr[-3000:])
        return 1
    new = json.loads(out.read_text())
    if new["status"] != "ok":
        print(f"{tag}: {new['status']} ({new.get('reason')})")
        return 0
    base_file = base_path(arch, shape)
    if not base_file.exists():
        print(f"no baseline {base_file} (run the dry run's --all first)")
        print(f"{tag:>10}: {values(new)}")
        return 0
    base = json.loads(base_file.read_text())
    print(f"{arch} x {shape}, {tag} {' '.join(flags)} (CPU dry run's "
          f"counts, rank 0 of 16x16)")
    for k, (b, n, ratio) in diff(base, new).items():
        tail = f"  ({ratio:.3f}x)" if ratio is not None else ""
        print(f"  {k}: {b} -> {n}{tail}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
