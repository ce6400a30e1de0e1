"""Edges of the queries completed in the window, over the window's wall.
The edges are the benchmark's own count (``queries/<kind>.py::work_edges``,
from the inputs and the reference's answers), never the program's."""


def read(run):
    return run.work_edges / run.window_s if run.window_s > 0 and run.queries else None
