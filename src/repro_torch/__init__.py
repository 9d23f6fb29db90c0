"""repro_torch — the PyTorch/CUDA port of the RECIPE reproduction.

A second package beside the JAX one (``repro``), with the same module
layout: ``core`` (PM simulator, conversion framework, the indexes,
plans, YCSB), ``kernels`` (host front-ends, CUDA kernel wrappers and
their plain PyTorch versions), ``api`` (sessions), ``distributed``
(shards and streams), ``obs`` (telemetry), ``configs`` and ``models``
(the dense-family LM), ``serving`` (the paged serving engine) and
``launch`` (the serving driver).  The CUDA sources are in ``csrc/`` and
are built at first use (``build.py``).  Entry points run on the card
unless the caller passes ``device="cpu"``.  This package imports
neither JAX nor ``repro``.
"""
