"""Models (the reference's ``repro.models``): the two-tower retrieval model
with the MLP it shares with the GNNs, and the decoder-only transformer LM
(prefill and decode; training waits for a later slice)."""
