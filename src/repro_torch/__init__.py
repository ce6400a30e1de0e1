"""PyTorch/CUDA port of the multi-query graph engine.

Mirrors the JAX package module for module: ``graph`` (construction +
statistics), ``algorithms`` (query executors), ``core`` (the scheduling
core and the execution backends) and ``kernels`` (hand-written CUDA kernels
under ``csrc/``, each with its plain PyTorch version). Entry points run on
the CUDA device unless the caller passes ``device="cpu"``."""
