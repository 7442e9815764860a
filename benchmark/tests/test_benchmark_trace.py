"""The trace reduction on synthetic events: busy time is the union of
device intervals inside the window, and the idle time splits exactly over
the harness's spans."""

import pytest

from benchmark import trace


class _Ev:
    def __init__(self, name, device, start, end, annotation=False):
        self._n, self._d, self._s, self._e = name, device, start, end
        self._a = annotation

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def is_user_annotation(self):
        return self._a


def test_busy_and_idle_split():
    s = 10**18
    ms = 10**6
    events = [_Ev("k1", True, s + 0, s + 10 * ms),
              _Ev("k2", True, s + 5 * ms, s + 20 * ms),     # overlaps k1
              _Ev("k1", True, s + 50 * ms, s + 60 * ms),
              _Ev("span", True, s, s + 100 * ms, annotation=True),
              _Ev("k3", True, s + 95 * ms, s + 130 * ms),   # clipped at 100
              _Ev("cudaLaunchKernel", False, s + 34 * ms, s + 36 * ms)]
    spans = [("model call", s + 0, s + 40 * ms)]
    out = trace.reduce(events, s, s + 100 * ms, spans)
    assert out["busy_s"] == pytest.approx(0.035)   # 0-20, 50-60, 95-100
    assert out["window_s"] == pytest.approx(0.1)
    assert out["kernels"]["k1"] == pytest.approx(0.02)
    assert "span" not in out["kernels"]
    idle = dict(out["idle_gaps"])
    assert idle["model call"] == pytest.approx(0.030)     # gap 20-50
    assert idle[trace.OUTSIDE] == pytest.approx(0.035)   # gap 60-95
    assert sum(idle.values()) == pytest.approx(0.1 - out["busy_s"])
    named = dict(trace.reduce(events, s, s + 100 * ms)["idle_gaps"])
    assert named["cudaLaunchKernel"] == pytest.approx(0.030)
    assert sum(named.values()) == pytest.approx(0.065)


def test_device_time_per_trained_image():
    from benchmark import run

    read = run.reader("train.device_ms_per_img")
    busy = {"busy_s": 3.0, "window_s": 4.0}
    assert read({"trace": busy, "images": 1500}) == pytest.approx(2.0)
    assert read({"trace": None, "images": 1500}) is None
    assert read({"trace": {"busy_s": 0.0, "window_s": 4.0},
                 "images": 1500}) is None
