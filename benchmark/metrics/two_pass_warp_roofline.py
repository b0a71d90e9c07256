"""The PCL warps' share of their memory roofline while serving: the
bytes the five decoder levels' warps need in a forward (each input byte
read once and each output byte written once, counted from the
configuration's shapes) at 3.35 TB/s, over the device time of the
kernels launched inside the range the benchmark opens around each call
into a PCL's warp, in %. Matched by range, not by kernel name, so it
reads the same work whatever implements the warp."""


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.range_device_s("bench.warp")
    if device_s is None:
        return None
    return 100.0 * run.warp_bound_s * run.trace.forwards / device_s
