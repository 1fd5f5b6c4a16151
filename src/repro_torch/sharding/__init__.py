"""Tensor-parallel serving on ``torch.distributed`` (port of
``repro.sharding``): ``tp`` holds the context, the collectives and the
shard functions, ``dist`` starts and joins the ranks."""
