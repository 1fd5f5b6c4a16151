"""Markdown tables from the dry run's records (port of
``tools/make_tables.py``).

Reads ``build/repro_torch/dryrun/*.json`` (``python -m
repro_torch.launch.dryrun --all --both``) and the hillclimb records
beside them (``build/repro_torch/hillclimb/``), and prints:

* the dry-run table, one row per arch x shape with both meshes side by
  side (16x16 / 2x16x16): status, seconds, resident and peak GB a rank,
  whether the peak fits an H100's 80 GB, FLOPs and collective (wire) GB
  a rank; a cell without a record reads MISSING, a skipped one
  "skip (full attn)", as JAX's table writes them;
* the 16x16 roofline table: the three terms, the dominant one, the
  model's share of the counted FLOPs, the roofline fraction, and the
  dry run's flags that would move the dominant term; ratios only where
  a hillclimb record of the cell exists (its three terms against the
  baseline's);
* the summary: cells, the worst roofline fractions, the most
  collective-bound cells.

Every figure is the CPU dry run's count (shapes only, rank 0).

Usage: python -m repro_torch.tools.make_tables [records_dir [hillclimb_dir]]
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from repro_torch.configs import registry, shapes as shp
from repro_torch.launch import dryrun

ARCHS = ["jamba-1.5-large-398b", "h2o-danube-3-4b", "phi3-medium-14b",
         "gemma3-12b", "minitron-4b", "mamba2-780m", "granite-moe-3b-a800m",
         "mixtral-8x22b", "qwen2-vl-72b", "whisper-small"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MESHES = ("16x16", "2x16x16")
MODEL_AXIS = 16
TERMS = {"compute": "t_compute_s", "memory": "t_memory_s",
         "collective": "t_collective_s"}


def load(d: Path) -> dict:
    """{(arch, shape, mesh): record} of the records under ``d``."""
    recs = {}
    for path in sorted(Path(d).glob("*.json")):
        r = json.loads(path.read_text())
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def load_hillclimb(d: Path) -> dict:
    """{(arch, shape): [records]} of the hillclimb variants under ``d``
    (16x16, status ok)."""
    out: dict = {}
    for path in sorted(Path(d).glob("*.json")) if Path(d).exists() else ():
        r = json.loads(path.read_text())
        if r.get("status") == "ok":
            out.setdefault((r["arch"], r["shape"]), []).append(r)
    return out


def _gb(n) -> str:
    return f"{n / 1e9:.2f}"


def _cell(r: dict | None, fn) -> str:
    if r is None:
        return "MISSING"
    if r["status"] == "skipped":
        return "skip (full attn)"
    return fn(r)


def dryrun_rows(recs: dict) -> list[str]:
    cols = (("status", lambda r: r["status"]),
            ("s", lambda r: f"{r['seconds']:.0f}"),
            ("resident GB", lambda r: _gb(r["resident_bytes"])),
            ("peak GB", lambda r: _gb(r["peak_bytes"])),
            ("fits 80 GB", lambda r: "yes" if r["fits"] else "no"),
            ("FLOPs a rank", lambda r: f"{r['flops_per_rank']:.3e}"),
            ("coll GB a rank",
             lambda r: _gb(r["roofline"]["coll_bytes"])))
    out = ["| arch | shape | " + " | ".join(c for c, _ in cols) + " |",
           "|---|---|" + "---|" * len(cols)]
    for arch in ARCHS:
        for shape in SHAPES:
            pair = [recs.get((arch, shape, m)) for m in MESHES]
            if all(r is not None and r["status"] == "skipped"
                   for r in pair):
                out.append(f"| {arch} | {shape} | skip (full attn) |"
                           + " |" * (len(cols) - 1))
                continue
            cells = [" / ".join(_cell(r, fn) for r in pair)
                     for _, fn in cols]
            out.append(f"| {arch} | {shape} | " + " | ".join(cells) + " |")
    return out


def _flags(levers: dict) -> str:
    """A hillclimb record's levers as the dry run's flags."""
    return " ".join(dryrun.lever_flags(levers)) or "(none)"


def lever(arch: str, shape: str, dominant: str) -> str:
    """The dry run's flags that would move the dominant term (named, not
    measured)."""
    cfg = registry.get(arch)
    kind = shp.SHAPES[shape].kind
    if dominant == "collective":
        if kind != "train":
            return "none: the serving cells already run TP shards"
        # the encoder-decoder reads no ``sequence_parallel``
        flags = [] if cfg.is_encoder_decoder else ["--seq-par"]
        e = cfg.moe_num_experts
        if cfg.uses_moe and e % MODEL_AXIS:
            flags.append(f"--moe-pad {-(-e // MODEL_AXIS) * MODEL_AXIS}")
        return (" ".join(f"`{f}`" for f in flags)
                or "none: the encoder-decoder reads no `sequence_parallel`")
    if kind == "decode":
        return "`--sparse 6 8 --precision int8` `--kv-int8`"
    if "swa" in cfg.unit_pattern:
        return "`--swa-tile-skip`"
    if kind == "train":
        return ("`--no-remat2`" if dominant == "compute" else
                "none: `--sparse` trains masked, at dense bytes")
    return "`--sparse 6 8 --precision int8`"


def measured(base: dict, variants: list[dict]) -> str:
    """Each hillclimb variant's roofline terms against the baseline's."""
    out = []
    for v in variants:
        ratios = []
        for name, term in TERMS.items():
            b, n = base["roofline"][term], v["roofline"][term]
            ratios.append(f"{name} {n / b:.3f}x" if b else f"{name} n/a")
        out.append(f"{_flags(v.get('levers', {}))}: {', '.join(ratios)}")
    return "; ".join(out)


def roofline_rows(recs: dict, hill: dict) -> list[str]:
    out = ["| arch | shape | t_compute s | t_memory s | t_collective s "
           "| dominant | model / counted FLOPs | roofline frac "
           "| to move the dominant term |",
           "|---|---|---|---|---|---|---|---|---|"]
    for arch in ARCHS:
        for shape in SHAPES:
            r = recs.get((arch, shape, "16x16"))
            if r is None or r["status"] != "ok":
                continue
            f = r["roofline"]
            text = lever(arch, shape, f["dominant"])
            if (arch, shape) in hill:
                text += "; hillclimb: " + measured(r, hill[arch, shape])
            out.append(
                f"| {arch} | {shape} | {f['t_compute_s']:.4f} "
                f"| {f['t_memory_s']:.4f} | {f['t_collective_s']:.4f} "
                f"| **{f['dominant']}** | {f['useful_flops_ratio']:.2f} "
                f"| {f['roofline_fraction']:.3f} | {text} |")
    return out


def summary_rows(recs: dict) -> list[str]:
    """Three lines: the cells, the six worst roofline fractions and the
    four most collective-bound cells (16x16)."""
    ok = sum(1 for r in recs.values() if r["status"] == "ok")
    skip = sum(1 for r in recs.values() if r["status"] == "skipped")
    want = len(ARCHS) * len(SHAPES) * len(MESHES)
    singles = [(k, r["roofline"]) for k, r in recs.items()
               if r["status"] == "ok" and k[2] == "16x16"]
    worst = sorted(singles, key=lambda kf: kf[1]["roofline_fraction"])[:6]

    def coll_share(f):
        return f["t_collective_s"] / max(1e-12, f["t_compute_s"],
                                         f["t_memory_s"])
    coll = sorted(singles, key=lambda kf: -coll_share(kf[1]))[:4]
    return [f"cells: {len(recs)} of {want} recorded, {ok} ok, {skip} "
            f"skipped (long_500k on full-attention stacks).",
            "Worst roofline fractions (16x16): " + "; ".join(
                f"{k[0]} x {k[1]} {f['roofline_fraction']:.3f} "
                f"({f['dominant']})" for k, f in worst) + ".",
            "Most collective-bound (16x16): " + "; ".join(
                f"{k[0]} x {k[1]} t_collective {f['t_collective_s']:.4f} s "
                f"vs {max(f['t_compute_s'], f['t_memory_s']):.4f} s"
                for k, f in coll) + "."]


def render(recs: dict, hill: dict) -> str:
    return "\n".join(
        ["### Dry run (16x16 / 2x16x16; CPU dry run's counts)", "",
         *dryrun_rows(recs), "", "### Roofline (16x16)", "",
         *roofline_rows(recs, hill), "", "\n\n".join(summary_rows(recs))])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    d = Path(argv[0]) if argv else dryrun.RESULTS_DIR
    h = Path(argv[1]) if len(argv) > 1 else d.parent / "hillclimb"
    print(render(load(d), load_hillclimb(h)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
