"""The port's example entry points, counterparts of the scripts in
``examples/``: ``quickstart``, ``serve_kv``, ``graph_pagerank``,
``train_hrm``, ``characterize`` and ``sharded_domain``. Each runs as
``python -m repro_torch.examples.<name>``, keeps the reference script's
flags, sizes, seeds and printed lines, adds ``--device`` (default: the
CUDA card) and ends with the reference's ``... OK`` line. The parameters
come from ``repro_torch.draws``, the same on every device; they differ from
the reference's ``jax.random`` draws."""
