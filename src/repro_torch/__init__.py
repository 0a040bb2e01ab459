"""PyTorch/CUDA port of the HRM system (``repro``): the same verbs and data
layout, with each Pallas TPU kernel rewritten by hand in CUDA for the H100.

Imports ``torch`` and ``numpy`` only; nothing of ``jax`` or ``repro``.
"""
