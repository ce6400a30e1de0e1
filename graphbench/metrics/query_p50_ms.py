"""Median wall latency of the window's queries, from their round's start."""
import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 50)) * 1e3 if run.queries else None
