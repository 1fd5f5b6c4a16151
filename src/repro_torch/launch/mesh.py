"""Production mesh construction (port of ``repro.launch.mesh``, DESIGN.md
section 4).

Functions, not module-level constants: importing this module never
touches ``torch.distributed``.  Single-pod: 16x16 = 256 ranks (data x
model).  Multi-pod: 2x16x16 = 512 ranks (pod x data x model); the 'pod'
axis carries only the gradient all-reduce.  Each needs the default
process group initialized with exactly that many ranks, and raises
naming the world size otherwise (as ``jax.make_mesh`` fails).  Both run
on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

from repro_torch.sharding.ctx import Mesh, world_size


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device=device)


def make_host_mesh(device=None) -> Mesh:
    """Whatever ranks exist, as a 1-D 'data' mesh (tests/examples)."""
    return Mesh((world_size(),), ("data",), device=device)


# The tensor-parallel *serving* context is deliberately not here: it lives
# with the rest of the TP serving machinery in sharding/tp.py, so runtime/
# never imports launch/.
