"""Share of the traced host rounds' wall spent outside the backend's
``prepare`` and ``execute``: the session loop and the scheduling core."""


def read(run):
    h = run.host
    if not h or h["rounds_wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - (h["prepare_s"] + h["execute_s"]) / h["rounds_wall_s"])
