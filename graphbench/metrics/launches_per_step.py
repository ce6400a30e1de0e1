"""Launches of the port's graph kernels (their own counters) per
``execute`` call in the traced host rounds."""


def read(run):
    h = run.host
    return h["launches"] / h["execute_calls"] if h and h["execute_calls"] else None
