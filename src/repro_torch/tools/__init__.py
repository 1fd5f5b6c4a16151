"""The dry run's tools, counterparts of the JAX repository's ``tools/``:
``hillclimb`` (a variant of one dry cell against its baseline record),
``make_tables`` (markdown tables from the dry run's records) and
``op_profile`` (one cell's largest tensors and collectives by call site,
as ``tools/hlo_profile.py`` reads them from the compiled HLO).  Each runs
on the CPU: ``python -m repro_torch.tools.<name> --help``."""
