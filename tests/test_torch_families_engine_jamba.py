"""The jamba hybrid (SSD + attention layers, MoE on every other layer)
served by the port's engine, held against the JAX engine at smoke width on
the CPU: IDENTICAL greedy streams, compressed and slided, recipes ``none``
and ``int8`` (the other families: ``test_torch_families_engine.py``)."""
import pytest

from families_engine import case_id, check_case

CASES = [("jamba-1.5-large-398b", m, r, 16.0)
         for m in ("compressed", "slided") for r in ("none", "int8")]


@pytest.mark.parametrize("arch,mode,recipe,cf", CASES,
                         ids=[case_id(*c) for c in CASES])
def test_family_engine_streams_match_jax_engine(arch, mode, recipe, cf):
    check_case(arch, mode, recipe, cf)
