"""Model layers (the reference's ``repro.layers``); so far the embedding
layers of the two-tower retrieval model."""
