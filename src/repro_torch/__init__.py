"""PyTorch/CUDA port of the multi-query graph engine and its model zoo's
serving and training paths.

Mirrors the JAX package module for module: ``graph`` (construction +
statistics), ``algorithms`` (query executors), ``core`` (the scheduling
core and the execution backends), ``kernels`` (hand-written CUDA kernels
under ``csrc/``, each with its plain PyTorch version), the two-tower
retrieval server (``layers.embedding``, ``models.recsys`` with the MLP of
``models.gnn.common``), and LM serving (``layers.{norms,rotary,mlp,
attention}``, ``models.transformer``, ``serving.ServingEngine``,
``launch.serve``), LM training (``models.transformer``'s forward and
loss, ``optim``, ``data``, ``ckpt``, ``launch.steps.lm_train_step``,
``launch.train``), with the configs in ``configs`` and the cell shapes in
``launch.steps``. Entry points run on the CUDA device unless the caller
passes ``device="cpu"``."""
