"""90th percentile of the window's query latencies (linear interpolation),
for cells whose windows hold too few queries for ten beyond a 95th."""
import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 90)) * 1e3 if run.queries else None
