"""Cell shapes. The reference's cell programs (``make_recsys_cell`` and
the LM/GNN cells) wait for a later slice; the retrieval server reads the
recsys shapes from here."""

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="score", batch=1, n_candidates=1_048_576),
}
