"""Tensor-parallel serving over two ranks: ``ServeEngine(tp=2)`` in two gloo
processes on the CPU, held against the port's tp=1 engine and the JAX
engine on the same weights (``params_from_jax``).

One module fixture prepares every case (its port config, packed weights,
engine config and traffic in a ``torch.save`` file), starts two ranks
(``sharding.dist.launch``) that serve them all, and meanwhile runs the
JAX tp=1 engine and the port's tp=1 engine here; beside them it starts a
JAX tp=2 engine (two forced host devices, as ``tests/test_tp_serve.py``
runs it) and ``launch/serve.py --engine --tp 2 --dist-backend gloo`` and
``--tp 1``.  The cases mirror the four parity tests of
``tests/test_tp_serve.py`` at their sizes: dense with bf16 and int8 KV;
compressed 2:4, 4:6 and 6:8; the fp8, w4 and int8 recipes; the jamba
hybrid; forced eviction (evictions, ``kv.check()``, every page free, each
rank's pool at KVH/2 heads); plus slided 6:8 int8 and one case with the
prefix cache, speculate=2, the overlapped loop and a ``FaultPlan``
together on dense int8 KV.  Both ranks' streams must be identical and
equal both references.  The collectives (``argmax_tokens`` with planted
cross-shard ties, ``rmsnorm``, ``reduce``, ``reduce_max``) run in the same
two ranks.
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import linear as jlin
from repro.models import model as JM
from repro.runtime import faults as jfl, serve_loop as jserve
from repro.sharding import tp as jtp

from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.core import linear as tlin
from repro_torch.runtime import faults as tfl, serve_loop as tserve
from repro_torch.sharding import dist as tdist

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the subprocesses run beside the suite's other workers: two threads each
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
       "OMP_NUM_THREADS": "2"}
ECFG = dict(max_batch=2, page_size=4, num_pages=24, max_seq_len=32,
            prefill_chunk=6)
NARROW = dict(d_model=48, num_heads=4, num_kv_heads=2, head_dim=12,
              num_layers=2)
PLAN = dict(seed=5, alloc_fail_rate=0.05, step_error_rate=0.08)
V, K1 = 16, 3                       # collectives: vocab, verify lanes


def _case(name, arch, over, sparsity, prompts, max_new, ecfg=ECFG, **kw):
    return dict(name=name, arch=arch, over=over, sparsity=sparsity,
                prompts=prompts, max_new=max_new, ecfg=dict(ecfg, **kw))


def _prompts(seed, sizes, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=k).tolist() for k in sizes]


def _cases():
    danube = "h2o-danube-3-4b"
    cases = [_case(f"dense-kv{kv}", danube,
                   dict(num_layers=2, kv_cache_dtype=kv), None,
                   _prompts(0, (7, 11, 9)), 4) for kv in ("bfloat16", "int8")]
    for n in (2, 3, 4):
        z, l = 2 * n - 2, 2 * n
        cases.append(_case(f"compressed-{z}:{l}", danube, NARROW,
                           dict(pattern=(z, l), mode="compressed"),
                           _prompts(1, (5, 9, 12)), 4))
    for recipe in ("fp8", "w4", "int8"):
        cases.append(_case(f"recipe-{recipe}", danube, NARROW,
                           dict(pattern=(6, 8), mode="compressed",
                                recipe=recipe),
                           _prompts(0, (5, 9, 12)), 4))
    cases.append(_case("hybrid", "jamba-1.5-large-398b", {}, None,
                       _prompts(2, (5, 9)), 4))
    cases.append(_case("eviction", danube, dict(num_layers=2),
                       dict(pattern=(6, 8), mode="compressed"),
                       _prompts(3, (9, 13, 11)), 8,
                       dict(max_batch=3, page_size=4, num_pages=7,
                            max_seq_len=28, prefill_chunk=8)))
    cases.append(_case("slided-6:8-int8", danube, dict(num_layers=2),
                       dict(pattern=(6, 8), mode="slided", recipe="int8",
                            fused_attention=True),
                       _prompts(4, (7, 11, 9)), 4))
    shared = _prompts(5, (8,))[0]
    cases.append(_case("features", danube,
                       dict(num_layers=2, kv_cache_dtype="int8"), None,
                       [shared + p for p in _prompts(6, (5, 3, 6, 4))], 6,
                       dict(max_batch=2, page_size=4, num_pages=32,
                            max_seq_len=40, prefill_chunk=6),
                       prefix_cache=True, speculate=2, async_loop=True,
                       faults=PLAN))
    return cases


def _cfg(reg, lin, case, **sp_kw):
    cfg = dataclasses.replace(reg.smoke_config(case["arch"]), **case["over"])
    if case["sparsity"] is not None:
        cfg = dataclasses.replace(cfg, sparsity=lin.SparsityConfig(
            **case["sparsity"], **sp_kw))
    return cfg


def _ecfg(mod, fl, case, tp):
    kw = dict(case["ecfg"])
    if "faults" in kw:
        kw["faults"] = fl.FaultPlan(**kw["faults"])
    return mod.EngineConfig(tp=tp, **kw)


def _serve(eng, case):
    for i, p in enumerate(case["prompts"]):
        eng.submit(p, case["max_new"], rid=i, arrival=i)
    out = eng.run()
    eng.kv.check()
    return {str(i): [c.status, c.tokens] for i, c in sorted(out.items())}


# the ranks: serve every case at tp=2, run the collectives, print a JSON
# line; imports neither jax nor repro
WORKER = textwrap.dedent("""
    import json, sys, torch
    from repro_torch.runtime import serve_loop
    from repro_torch.sharding import dist as tdist, tp
    rank, world = tdist.init("gloo")
    tdist.device_for("cpu")
    root = sys.argv[1]
    out = {}
    for name in json.load(open(f"{root}/cases.json")):
        case = torch.load(f"{root}/{name}.pt", weights_only=False)
        eng = serve_loop.ServeEngine(case["params"], case["cfg"],
                                     case["ecfg"], device="cpu")
        eng.warmup()
        for i, p in enumerate(case["prompts"]):
            eng.submit(p, case["max_new"], rid=i, arrival=i)
        done = eng.run()
        eng.kv.check()
        s = eng.stats
        pools = [leaf.shape[2] for u in eng.cache for lp in u.values()
                 if "k" in lp for leaf in (lp["k"],)]
        out[name] = {
            "streams": {str(i): [c.status, c.tokens]
                        for i, c in sorted(done.items())},
            "tp": s.tp, "evictions": s.evictions,
            "free": eng.kv.pool.num_free + eng.kv.pool.num_cached,
            "kv_heads": pools, "captures": eng.captures,
            "hits": s.prefix_hit_tokens, "verify": s.verify_steps,
            "faults": s.faults_injected, "cow": s.cow_copies}
    c = torch.load(f"{root}/coll.pt")
    vl, dl = c["l2"].shape[-1] // world, c["x"].shape[-1] // world
    own = lambda t, n: t[..., rank * n:(rank + 1) * n]
    tp.reset_counts()
    with tp.activate():
        coll = {"ids2": tp.argmax_tokens(own(c["l2"], vl)),
                "ids3": tp.argmax_tokens(own(c["l3"], vl)),
                "norm": tp.rmsnorm({"g": own(c["g"], dl)}, own(c["x"], dl)),
                "sum": tp.reduce(c["parts"][rank]),
                "max": tp.reduce_max(c["parts"][rank]),
                "whole": tp.gather_last(own(c["l2"], vl)),
                "count": tp.collective_count()}
    torch.save(coll, f"{root}/coll{rank}.pt")
    torch.distributed.destroy_process_group()
    print("RESULT " + json.dumps(out))
""")

# the JAX engine at tp=2 over two forced host devices, on the int8 recipe
# case (tests/test_tp_serve.py's harness)
JAX_TP2 = textwrap.dedent("""
    import dataclasses, json, numpy as np, jax
    from repro.configs import registry
    from repro.core.linear import SparsityConfig
    from repro.models import model as M
    from repro.runtime import serve_loop
    base = dataclasses.replace(registry.smoke_config("h2o-danube-3-4b"),
                               **NARROW)
    cfg = dataclasses.replace(base, sparsity=SparsityConfig(
        pattern=(6, 8), mode="compressed", recipe="int8"))
    params = serve_loop.pack_params(M.init(base, jax.random.PRNGKey(0)), cfg)
    eng = serve_loop.ServeEngine(params, cfg, serve_loop.EngineConfig(
        tp=2, **ECFG))
    assert eng.stats.tp == 2
    for i, p in enumerate(PROMPTS):
        eng.submit(p, 4, rid=i, arrival=i)
    out = eng.run()
    print("RESULT " + json.dumps({str(i): out[i].tokens for i in out}))
""")

LAUNCH = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
          "h2o-danube-3-4b", "--smoke", "--sparse", "6", "8", "--precision",
          "int8", "--engine", "--fused-attention", "--device", "cpu",
          "--new-tokens", "8", "--dist-backend", "gloo"]


def _result(text):
    line = next(ln for ln in text.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _collective_inputs():
    rng = np.random.default_rng(7)
    l2 = rng.standard_normal((6, V)).astype(np.float32)
    l3 = rng.standard_normal((2, K1, V)).astype(np.float32)
    # planted equal maxima: across the shard boundary (the lower global
    # index must win), within one shard, and at each shard's first column
    for row, cols in enumerate([(3, 11), (8, 15), (0, 8), (5, 6), (7, 8),
                                (2, 9, 14)]):
        l2[row, list(cols)] = 9.0
    l3[0, 1, [6, 10]] = 9.0
    l3[1, 2, [9, 12]] = 9.0
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    parts = rng.standard_normal((2, 4, 5)).astype(np.float32)
    return l2, l3, x, g, parts


@pytest.fixture(scope="module")
def tp_run():
    cases = _cases()
    jax_case = next(c for c in cases if c["name"] == "recipe-int8")
    side = {
        "jax_tp2": subprocess.Popen(
            [sys.executable, "-c", f"NARROW = {NARROW!r}\nECFG = {ECFG!r}\n"
             f"PROMPTS = {jax_case['prompts']!r}\n" + JAX_TP2],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**ENV, "XLA_FLAGS":
                 "--xla_force_host_platform_device_count=2"})}
    with tempfile.TemporaryDirectory() as root:
        jtrees, ranks = {}, {}
        for case in cases:
            jcfg = _cfg(jreg, jlin, case, use_pallas=False)
            raw = JM.init(jcfg, jax.random.PRNGKey(0))
            pack = functools.partial(jserve.pack_params, cfg=jcfg)
            if not jcfg.sparsity.recipe.quantized:
                # jitted: bit-equal to the eager pack here and 10x faster;
                # a quantized recipe packs eagerly (XLA rewrites a / 127
                # as a * (1 / 127) under jit)
                pack = jax.jit(pack)
            jtrees[case["name"]] = (jcfg, pack(raw)
                                    if jcfg.sparsity.pattern else raw)
            tcfg = _cfg(treg, tlin, case)
            params = tserve.pack_params(params_from_jax(
                jax.tree_util.tree_map(np.asarray, raw), tcfg, device="cpu"),
                tcfg)
            case["tcfg"], case["tparams"] = tcfg, params
            torch.save({"cfg": tcfg, "params": params,
                        "ecfg": _ecfg(tserve, tfl, case, 2),
                        "prompts": case["prompts"],
                        "max_new": case["max_new"]},
                       f"{root}/{case['name']}.pt")
        with open(f"{root}/cases.json", "w") as f:
            json.dump([c["name"] for c in cases], f)
        l2, l3, x, g, parts = _collective_inputs()
        torch.save({k: torch.from_numpy(v) for k, v in
                    dict(l2=l2, l3=l3, x=x, g=g, parts=parts).items()},
                   f"{root}/coll.pt")

        def ranks_run():
            try:
                ranks["out"] = tdist.launch(
                    [sys.executable, "-c", WORKER, root], 2, env=ENV,
                    timeout=600)
            except Exception as e:  # reported by the tests below
                ranks["error"] = e

        worker = threading.Thread(target=ranks_run)
        worker.start()
        side["serve1"] = subprocess.Popen(
            LAUNCH + ["--tp", "1"], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=ENV)
        side["serve2"] = subprocess.Popen(
            LAUNCH + ["--tp", "2"], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=ENV)
        # meanwhile: JAX's and the port's tp=1 engines here
        refs = {}
        for case in cases:
            jcfg, tree = jtrees[case["name"]]
            refs[case["name"]] = {
                "jax": _serve(jserve.ServeEngine(
                    tree, jcfg, _ecfg(jserve, jfl, case, 1)), case),
                "port": _serve(tserve.ServeEngine(
                    case["tparams"], case["tcfg"],
                    _ecfg(tserve, tfl, case, 1), device="cpu"), case)}
        worker.join()
        colls = ([torch.load(f"{root}/coll{r}.pt") for r in range(2)]
                 if "out" in ranks else None)
    texts = {k: p.communicate(timeout=600) + (p.returncode,)
             for k, p in side.items()}
    return {"cases": {c["name"]: c for c in cases}, "refs": refs,
            "ranks": ranks, "colls": colls, "side": texts,
            "inputs": (l2, l3, x, g, parts)}


def _ranks(tp_run):
    if "error" in tp_run["ranks"]:
        raise tp_run["ranks"]["error"]
    return [_result(o) for o in tp_run["ranks"]["out"]]


CASE_NAMES = [c["name"] for c in _cases()]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_tp2_streams_equal_tp1_and_jax(tp_run, name):
    r0, r1 = (r[name] for r in _ranks(tp_run))
    assert r0["streams"] == r1["streams"], "the ranks disagree"
    ref = tp_run["refs"][name]
    assert ref["port"] == ref["jax"], "port tp=1 differs from JAX tp=1"
    assert r0["streams"] == ref["port"]
    assert r0["tp"] == 2
    assert set(r0["captures"].values()) == {0}   # TP steps run eager
    case = tp_run["cases"][name]
    assert r0["kv_heads"] == [case["tcfg"].num_kv_heads // 2] * len(
        r0["kv_heads"])
    assert r0["free"] == case["ecfg"]["num_pages"]
    if name == "eviction":
        assert r0["evictions"] > 0, "pressure did not force an eviction"
    if name == "features":
        statuses = {s for s, _ in r0["streams"].values()}
        assert r0["hits"] > 0 and r0["verify"] > 0 and r0["faults"] > 0
        assert "OK" in statuses


def test_tp2_equals_jax_tp2_engine(tp_run):
    out, err, rc = tp_run["side"]["jax_tp2"]
    assert rc == 0, err[-3000:]
    want = _result(out)
    got = _ranks(tp_run)[0]["recipe-int8"]["streams"]
    assert {k: toks for k, (_, toks) in got.items()} == want


def test_collectives_over_two_ranks(tp_run):
    _ranks(tp_run)
    l2, l3, x, g, parts = tp_run["inputs"]
    c0, c1 = tp_run["colls"]
    for key in ("ids2", "ids3", "sum", "max", "whole"):
        assert torch.equal(c0[key], c1[key]), key
    # ties to the lowest global index, as jnp.argmax on the whole logits
    np.testing.assert_array_equal(c0["ids2"].numpy(),
                                  np.asarray(jnp.argmax(l2, -1)))
    np.testing.assert_array_equal(c0["ids3"].numpy(),
                                  np.asarray(jnp.argmax(l3, -1)))
    assert c0["ids2"].dtype == torch.int32
    assert c0["ids2"].tolist()[:6] == [3, 8, 0, 5, 7, 2]
    np.testing.assert_array_equal(c0["whole"].numpy(), l2)
    want = np.asarray(jtp.rmsnorm({"g": jnp.asarray(g)}, jnp.asarray(x)))
    got = torch.cat([c0["norm"], c1["norm"]], -1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(c0["sum"].numpy(), parts[0] + parts[1])
    np.testing.assert_array_equal(c0["max"].numpy(),
                                  np.maximum(parts[0], parts[1]))
    assert c0["count"] == c1["count"] == 8  # 2 + 2 + 1 + 1 + 1 + 1


def test_launcher_tp2_prints_tp1_streams(tp_run):
    lines = {}
    for key in ("serve1", "serve2"):
        out, err, rc = tp_run["side"][key]
        assert rc == 0, err[-3000:]
        lines[key] = [ln for ln in out.splitlines()
                      if ln.startswith("[launch.serve] streams: ")]
        assert len(lines[key]) == 1, out
    assert lines["serve1"] == lines["serve2"]
    assert "tp=2" in tp_run["side"]["serve2"][0]
