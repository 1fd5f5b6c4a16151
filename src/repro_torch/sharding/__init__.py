"""Sharding on ``torch.distributed`` (port of ``repro.sharding``): ``rules``
maps logical axes to a named mesh's axes (``ctx.Mesh``) for training,
``tp`` holds tensor-parallel serving's context, collectives and shard
functions, ``dist`` starts and joins the ranks."""
from .rules import (  # noqa: F401
    param_spec, params_shardings, batch_spec, batch_shardings,
    cache_spec, cache_shardings, opt_state_shardings,
)
