"""Model layers (the reference's ``repro.layers``): the embedding layers of
the two-tower retrieval model, and the LM's norms, RoPE, MLPs and
attention (the flash-attention kernel on the card)."""
