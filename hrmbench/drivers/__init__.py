"""Drivers, one a cell ``kind``: ``run(ctx) -> record``. A record holds
``setup_s``, ``attempted``, ``failed``, ``memory_peak_bytes``, ``checks``
(``(name, value, limit, "max"|"min")``) and whatever the cell's metric
readers read; a traced run adds ``profile``."""
