"""The least time the profiled rounds' queries need (all their needed
bytes at the published HBM peak), over the device's busy time there (the
union of every device operation). Only from a profile that saw every
launch."""


def read(run):
    b, need = run.block, run.needed_bytes
    if b is None or not need or b.busy_s <= 0:
        return None
    return 100.0 * sum(need.values()) / run.peak_bytes_per_s / b.busy_s
