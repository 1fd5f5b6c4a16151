"""mamba2 (SSD only) and the dense gemma3 (5:1 local:global windows),
phi3 and minitron configs served by the port's engine, held against the
JAX engine at smoke width on the CPU: IDENTICAL greedy streams (mamba2
compressed and slided, recipes ``none`` and ``int8``; the dense configs
compressed int8; the other families: ``test_torch_families_engine.py``)."""
import pytest

from families_engine import case_id, check_case

CASES = [("mamba2-780m", m, r, 16.0) for m in ("compressed", "slided")
         for r in ("none", "int8")]
# the dense configs of the rest of ROADMAP A.3: they need no code of their
# own
CASES += [(a, "compressed", "int8", 16.0)
          for a in ("gemma3-12b", "phi3-medium-14b", "minitron-4b")]


@pytest.mark.parametrize("arch,mode,recipe,cf", CASES,
                         ids=[case_id(*c) for c in CASES])
def test_family_engine_streams_match_jax_engine(arch, mode, recipe, cf):
    check_case(arch, mode, recipe, cf)
