"""Cell shapes. The reference's cell programs (``make_recsys_cell`` and
the LM/GNN cells) wait for a later slice; the retrieval server and the LM
configs read the shapes from here."""

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="score", batch=1, n_candidates=1_048_576),
}
