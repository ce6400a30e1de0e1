"""The least time the profiled rounds' queries need of the spmv kernel's
work (their needed bytes at the published HBM peak), over the kernel's own
device time there. Only from a profile that saw every launch."""


def read(run):
    b, need = run.block, run.needed_bytes
    if b is None or not need or not need.get("spmv") or b.kernel_s["spmv"] <= 0:
        return None
    return 100.0 * need["spmv"] / run.peak_bytes_per_s / b.kernel_s["spmv"]
