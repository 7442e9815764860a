"""dw_chain_roofline: the fused depthwise tail's share of its
roofline over the window's calls: the least time of their tails' bytes and
operations (``roofline.dw_chain_bound_s`` from the configuration's
``dw_chain`` counts, at each served call's padded buckets) over the device
time of the kernels named ``dw_chain`` in the trace of the window."""

from benchmark import roofline


def read(run: dict):
    trace, work = run["trace"], run["dw_chain"]
    if trace is None or work is None:
        return None
    device_s = sum(s for name, s in trace["kernels"].items()
                   if "dw_chain" in name)
    if device_s <= 0:
        return None
    buckets = [b for _, _, n, *_ in run["calls"]
               for b in roofline.buckets_of(n, run["buckets"])]
    bound = roofline.dw_chain_bound_s(work, buckets, run["peak_flops"])
    return 100.0 * bound / device_s
