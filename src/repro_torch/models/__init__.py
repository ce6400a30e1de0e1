"""Models (the reference's ``repro.models``): the two-tower retrieval model,
the decoder-only transformer LM (prefill, decode, and the training forward
and loss), and the GNN family (``gnn``: MeshGraphNet, PNA, SchNet,
GraphCast) with the MLP the towers share."""
