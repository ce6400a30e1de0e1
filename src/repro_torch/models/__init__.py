"""Models (the reference's ``repro.models``); so far the two-tower
retrieval model and the MLP it shares with the GNNs."""
