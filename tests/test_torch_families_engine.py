"""The other model families served by the port's engine, held against the
JAX engine: granite-moe (attention + MoE), mamba2 (SSD only), mixtral
(sliding-window attention + MoE) and the jamba hybrid (SSD + attention
layers, MoE on every other layer), at smoke width on the CPU.

The port's ``ServeEngine`` and the JAX ``ServeEngine`` serve the same
weights (JAX ``init``, every SSM ``wo`` drawn in numpy, since JAX
zero-initialises it) and the same staggered traffic, and must emit
IDENTICAL greedy streams, compressed and slided, recipes ``none`` and
``int8``; one granite case at the registered capacity factor 1.25, where
the decode batch's tokens compete for expert capacity; and the dense
gemma3, phi3 and minitron configs, compressed int8.  The one-shot
``generate`` parity is in ``test_torch_moe.py`` and ``test_torch_ssm.py``.

The cases are split over three files so that the test workers share
them: the MoE stacks here, jamba in ``test_torch_families_engine_jamba.py``,
mamba2 and the dense configs in ``test_torch_families_engine_mamba2.py``
(the engines and the check in ``families_engine.py``).
"""
import pytest

from families_engine import case_id, check_case

CASES = [(a, m, r, 16.0) for a in ("granite-moe-3b-a800m", "mixtral-8x22b")
         for m in ("compressed", "slided") for r in ("none", "int8")]
CASES += [("granite-moe-3b-a800m", m, "int8", 1.25)
          for m in ("compressed", "slided")]


@pytest.mark.parametrize("arch,mode,recipe,cf", CASES,
                         ids=[case_id(*c) for c in CASES])
def test_family_engine_streams_match_jax_engine(arch, mode, recipe, cf):
    check_case(arch, mode, recipe, cf)
