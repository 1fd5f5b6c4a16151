"""The dry run's levers and the tools built on its records.

- ``--swa-tile-skip``, ``--moe-pad N`` and ``--act-quant int8`` reach the
  cell's config as JAX's dry run maps them (the legacy flag resolving to
  JAX's int8 recipe), each record names its levers, and ``--all`` hands
  every lever to its cells' processes;
- ``tools.hillclimb``: the diff of two smoke records, and ``main`` run
  in process (the variant's process replaced by a smoke record);
- ``tools.make_tables``: rows of ok, MISSING and skipped cells, and a
  lever column that names flags and quotes a ratio only from a port
  hillclimb record;
- ``tools.op_profile``: its collectives by call site add up to the
  record's, and its largest tensors name the port function that made
  them.

Cells run at smoke size (the registry swapped for its smoke configs),
as ``tests/test_torch_dryrun.py`` runs them.
"""
import dataclasses
import json
import types

import pytest

from repro.core import linear as jlin

from repro_torch.configs import registry as treg, shapes as tshp
from repro_torch.launch import dryrun
from repro_torch.tools import hillclimb, make_tables, op_profile

ARCH = "h2o-danube-3-4b"


@pytest.fixture(scope="module")
def smoke():
    """The dry run over smoke configs at 4 layers and a 32-token
    train_4k cell: its run_cell."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dryrun, "registry", types.SimpleNamespace(
            get=lambda a: dataclasses.replace(treg.smoke_config(a),
                                              num_layers=4),
            ARCH_IDS=treg.ARCH_IDS))
        mp.setitem(dryrun.shp.SHAPES, "train_4k",
                   tshp.ShapeSpec("train_4k", 32, 32, "train"))
        yield dryrun.run_cell


@pytest.fixture(scope="module")
def profiled(smoke):
    """The baseline smoke train cell under ``op_profile`` (tensors of
    4 kB and more noted)."""
    return op_profile.profile(ARCH, "train_4k", min_bytes=4096)


@pytest.fixture(scope="module")
def records(smoke, profiled):
    """A baseline smoke train record and its single-level-remat variant."""
    base = profiled["record"]
    var = smoke(ARCH, "train_4k", False, verbose=False, no_remat2=True)
    assert base["status"] == var["status"] == "ok"
    return base, var


def test_levers_reach_the_config(smoke, monkeypatch):
    seen = []

    def capture(cfg, *a, **k):
        seen.append(cfg)
        raise RuntimeError("captured")

    monkeypatch.setattr(dryrun, "serve_step_dry", capture)
    with pytest.raises(RuntimeError, match="captured"):
        smoke("granite-moe-3b-a800m", "decode_32k", False, verbose=False,
              swa_tile_skip=True, moe_pad=48, sparse=(6, 8),
              act_quant="int8")
    cfg = seen[0]
    assert cfg.swa_tile_skip and cfg.moe_expert_padding == 48
    want = jlin.SparsityConfig(pattern=(6, 8), mode="compressed",
                               act_quant="int8", use_pallas=False)
    got = cfg.sparsity
    assert (got.pattern, got.mode, got.act_quant) == \
        (want.pattern, want.mode, want.act_quant)
    assert dataclasses.astuple(got.recipe) == (
        want.recipe.name, want.recipe.act, want.recipe.weight,
        want.recipe.out)
    # the skip reaches every sliding-window layer's spec
    from repro_torch.models import transformer
    assert transformer.attn_spec(cfg, "swa").tile_skip


def test_records_name_their_levers(smoke, records):
    base, var = records
    assert base["levers"] == {} and var["levers"] == {"no_remat2": True}
    skipped = smoke("phi3-medium-14b", "long_500k", False, verbose=False,
                    moe_pad=48, swa_tile_skip=True)
    assert skipped["status"] == "skipped"
    assert skipped["levers"] == {"moe_pad": 48, "swa_tile_skip": True}


def test_all_hands_every_lever_on(monkeypatch, tmp_path):
    cmds = []

    class Done:
        def __init__(self, cmd):
            cmds.append(cmd)

        def poll(self):
            return 0

    monkeypatch.setattr(dryrun.subprocess, "Popen", Done)
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    monkeypatch.setattr(dryrun, "all_cells",
                        lambda meshes: [(ARCH, "train_4k", m) for m in meshes])
    flags = ["--swa-tile-skip", "--moe-pad", "48", "--sparse", "6", "8",
             "--act-quant", "int8", "--seq-par", "--kv-int8",
             "--grad-accum", "2", "--opt-state", "float32"]
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--all", "--both", *flags])
    assert e.value.code == 0 and len(cmds) == 2
    for cmd in cmds:
        tail = cmd[cmd.index("--json") + 2:]
        assert sorted(tail) == sorted(flags), tail


def test_hillclimb_diff(records):
    base, var = records
    d = hillclimb.diff(base, var)
    assert set(d) == set(hillclimb.TERMS) | set(hillclimb.COUNTS)
    b, n, ratio = d["flops_per_rank"]
    assert n < b and ratio == n / b
    assert d["dominant"][2] is None
    same = hillclimb.diff(base, base)
    assert all(r in (None, 1.0) for _, _, r in same.values())


def test_hillclimb_main_in_process(records, monkeypatch, tmp_path, capsys):
    base, var = records
    monkeypatch.setattr(hillclimb, "BASE_DIR", tmp_path / "dryrun")
    monkeypatch.setattr(hillclimb, "OUT_DIR", tmp_path / "hillclimb")
    hillclimb.BASE_DIR.mkdir()
    hillclimb.base_path(ARCH, "train_4k").write_text(json.dumps(base))
    calls = []

    def fake(arch, shape, out, flags):
        calls.append((arch, shape, flags))
        out.write_text(json.dumps(var))
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(hillclimb, "run_variant", fake)
    assert hillclimb.main([ARCH, "train_4k", "r1", "--no-remat2"]) == 0
    assert calls == [(ARCH, "train_4k", ["--no-remat2"])]
    text = capsys.readouterr().out
    assert "flops_per_rank" in text and "x)" in text
    assert hillclimb.variant_path(ARCH, "train_4k", "r1").exists()

    def failed(arch, shape, out, flags):
        return types.SimpleNamespace(returncode=1, stdout="", stderr="boom")

    monkeypatch.setattr(hillclimb, "run_variant", failed)
    assert hillclimb.main([ARCH, "train_4k", "r2", "--seq-par"]) == 1


def test_make_tables_rows(records, smoke):
    base, var = records
    skipped = {"arch": "phi3-medium-14b", "shape": "long_500k",
               "levers": {}, "status": "skipped", "reason": "full attention"}
    recs = {(ARCH, "train_4k", "16x16"): base,
            ("phi3-medium-14b", "long_500k", "16x16"): skipped,
            ("phi3-medium-14b", "long_500k", "2x16x16"):
                dict(skipped, mesh="2x16x16")}
    rows = make_tables.dryrun_rows(recs)
    assert len(rows) == 2 + len(make_tables.ARCHS) * len(make_tables.SHAPES)
    danube = next(r for r in rows if r.startswith(f"| {ARCH} | train_4k |"))
    assert "ok / MISSING" in danube
    assert f"{base['peak_bytes'] / 1e9:.2f} / MISSING" in danube
    phi3 = next(r for r in rows
                if r.startswith("| phi3-medium-14b | long_500k |"))
    assert "skip (full attn)" in phi3 and "MISSING" not in phi3
    assert "| MISSING / MISSING |" in rows[-1]

    roof = make_tables.roofline_rows(recs, {})
    assert len(roof) == 3
    lever_col = roof[-1].split("|")[-2]
    assert "--" in lever_col
    for tpu in ("6.9x", "~100x", "0.37x", "0.60x", "hillclimb"):
        assert tpu not in lever_col
    var = dict(var, roofline=dict(var["roofline"]))
    roof = make_tables.roofline_rows(recs, {(ARCH, "train_4k"): [var]})
    ratio = (var["roofline"]["t_compute_s"]
             / base["roofline"]["t_compute_s"])
    assert f"--no-remat2: compute {ratio:.3f}x, memory " in roof[-1]
    summary = make_tables.summary_rows(recs)
    assert summary[0].startswith("cells: 3 of 80 recorded, 1 ok, 2 skipped")


@pytest.mark.parametrize("arch, flag", [
    ("whisper-small", None), (ARCH, "`--seq-par`")])
def test_lever_names_seq_par_only_where_it_is_read(arch, flag):
    """A collective-bound training cell is pointed at ``--seq-par`` only
    where the model reads it: the encoder-decoder does not."""
    text = make_tables.lever(arch, "train_4k", "collective")
    if flag is None:
        assert "--seq-par" not in text and text.startswith("none:")
    else:
        assert flag in text


def test_op_profile_adds_up(profiled):
    p = profiled
    rec = p["record"]
    assert rec["status"] == "ok"
    kinds = rec["collectives"]
    assert kinds
    assert sum(c for c, _ in p["collectives"].values()) == \
        sum(k["count"] for k in kinds.values())
    assert sum(b for _, b in p["collectives"].values()) == \
        sum(k["bytes"] for k in kinds.values())
    for kind in kinds:
        assert sum(b for (k, _), (_, b) in p["collectives"].items()
                   if k == kind) == kinds[kind]["bytes"]
    assert all("tools/" not in site and "sharding/ctx.py" not in site
               for _, site in p["collectives"])
    sizes = [t[0] for t in p["tensors"]]
    assert sizes and sizes == sorted(sizes, reverse=True)
    assert any(t[4].startswith("models/") for t in p["tensors"])
    text = "\n".join(op_profile.report(p))
    assert "collectives by kind and call site" in text
