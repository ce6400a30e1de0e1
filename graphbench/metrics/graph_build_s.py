"""The port's construction in set-up: ``build_graph`` and the backend's
table staging (its ``prepare`` calls in the warm-up round)."""


def read(run):
    return run.graph_build_s
