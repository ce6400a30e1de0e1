"""PyTorch/CUDA port of the multi-query graph engine and its retrieval server.

Mirrors the JAX package module for module: ``graph`` (construction +
statistics), ``algorithms`` (query executors), ``core`` (the scheduling
core and the execution backends), ``kernels`` (hand-written CUDA kernels
under ``csrc/``, each with its plain PyTorch version), and the two-tower
retrieval server: ``layers.embedding``, ``models.recsys`` (with the MLP of
``models.gnn.common``), ``configs``, ``launch.steps`` and
``serving.plan_group_width``. Entry points run on the CUDA device unless
the caller passes ``device="cpu"``."""
