"""resize_roofline: the bilinear resizes' share of their roofline over the
window: the least time of their bytes at the HBM rate (each ``ops.resize``
span's input read once and output written once, from its shapes and
itemsize: the op's contract, whatever kernel computes it) over the device
seconds of what those spans launched (``device_by_program_span``,
``trace.ProgramTracer``). None without the program's spans."""

import math

from benchmark import roofline


def read(run: dict):
    trace = run["trace"]
    if trace is None or "device_by_program_span" not in trace:
        return None
    device_s = trace["device_by_program_span"].get("ops.resize", 0.0)
    nbytes = sum((math.prod(a["shape"]) + math.prod(a["out_shape"]))
                 * a["itemsize"] for a in
                 (s["attrs"] for s in trace["program_spans"]
                  if s["name"] == "ops.resize"))
    if device_s <= 0:
        return None
    return 100.0 * nbytes / roofline.HBM_BYTES_S / device_s
