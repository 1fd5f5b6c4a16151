"""Command-line entry points, and the mesh constructors.

``dryrun`` is not imported here, as JAX's note keeps it out: it is run
as the main module of its own process (``python -m
repro_torch.launch.dryrun``).
"""
from .mesh import make_production_mesh, make_host_mesh  # noqa: F401
