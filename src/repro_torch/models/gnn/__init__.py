"""GNN machinery (the reference's ``repro.models.gnn``); so far only the
MLP of ``common``, which the two-tower towers use."""
