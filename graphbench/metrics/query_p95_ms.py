"""95th percentile of the window's query latencies (linear interpolation)."""
import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 95)) * 1e3 if run.queries else None
