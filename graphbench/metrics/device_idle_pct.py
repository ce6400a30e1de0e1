"""Share of the profiled rounds' wall in which no operation ran on the
device. Only from a profile that saw every launch."""


def read(run):
    b = run.block
    return 100.0 * (1.0 - b.busy_s / b.window_s) if b is not None and b.window_s > 0 else None
