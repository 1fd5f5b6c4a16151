"""Elastic scaling: rebuild the mesh from the surviving ranks and reshard
(port of ``repro.runtime.elastic``).

On node failure the job restarts with fewer (or later, more) ranks: the
launcher calls ``elastic_mesh()`` to build the largest valid mesh over
the ranks that exist, then ``reshard()`` cuts each rank's pieces of the
restored host arrays for it.  Checkpoints hold whole (logical) arrays
(``checkpoint/checkpointer.py``), so restore-time resharding is exact
whatever the previous topology.
"""
from __future__ import annotations

from repro_torch.sharding import rules
from repro_torch.sharding.ctx import Mesh, world_size


def mesh_shape(n: int, prefer_model: int = 16) -> tuple[int, int]:
    """(data, model) over ``n`` ranks: the model axis targets
    ``prefer_model`` but degrades by halving so TP stays valid when a
    slice loses ranks (the divisibility-aware rules handle the rest)."""
    model = prefer_model
    while model > 1 and n % model:
        model //= 2
    return n // model, model


def elastic_mesh(prefer_model: int = 16, device=None) -> Mesh:
    """Largest (data, model) mesh over the ranks of the job
    (``mesh_shape``).  On the card unless the caller asks for the CPU."""
    return Mesh(mesh_shape(world_size(), prefer_model), ("data", "model"),
                device=device)


def reshard(tree, mesh: Mesh):
    """This rank's pieces of a whole (host or device) parameter tree on
    ``mesh``, per the sharding rules."""
    return rules.shard(tree, rules.params_shardings(tree, mesh), mesh)
