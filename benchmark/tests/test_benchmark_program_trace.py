"""The program's spans in a trace (``trace.ProgramTracer``) on synthetic
events, the readers of the metrics they feed, and runs on the CPU: a traced
``benchmark.run`` hands the readers the program's spans, the untraced one
never turns the recorder on, and a program without the recorder or its
counters leaves out only the new metrics."""

import json
import os
from unittest import mock

import pytest
import torch

from benchmark import program_trace as pt
from benchmark import run, trace
from sod100k_tpu_torch.utils import profiler

S = 10**18
MS = 10**6
SEED = 2**31 + 4343
SERVE = {"config": {"hw": 64, "buckets": [1, 4]},
         "traffic": {"rate_img_s": 24, "pool": 8}}
TRAIN = {"config": {"basewidth": 8, "hw": 32},
         "traffic": {"batch": 4, "resident_batches": 5}}
NEW = {"serve.queue_ms", "serve.pad_share"}


class _Ev:
    def __init__(self, name, device, start, end, corr=0):
        self._n, self._d, self._s, self._e, self._c = (name, device, start,
                                                       end, corr)

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._c


def _span(name, a, b, thread="MainThread", **attrs):
    return {"name": name, "start_ns": S + a * MS, "end_ns": S + b * MS,
            "thread_name": thread, "attrs": attrs}


# window 0-100 ms; kernels k1 (launched at 5, inside the forward), k2
# (launched at 12, inside the resize under it), k3 (launched at 70, in no
# span) and a copy launched from an unknown call
EVENTS = [_Ev("cudaLaunchKernel", False, S + 5 * MS, S + 6 * MS, 1),
          _Ev("k1", True, S + 10 * MS, S + 20 * MS, 1),
          _Ev("cudaLaunchKernel", False, S + 12 * MS, S + 13 * MS, 2),
          _Ev("k2", True, S + 30 * MS, S + 40 * MS, 2),
          _Ev("cudaLaunchKernel", False, S + 70 * MS, S + 71 * MS, 3),
          _Ev("k3", True, S + 75 * MS, S + 80 * MS, 3),
          _Ev("memcpy", True, S + 90 * MS, S + 95 * MS, 99)]
SPANS = [_span("train.step", 0, 60), _span("train.forward", 2, 45),
         _span("ops.resize", 11, 15, shape=(1, 1, 2, 2),
               out_shape=(1, 1, 4, 4), itemsize=4),
         _span("train.backward", 45, 60),
         _span("elsewhere", 0, 100, thread="other")]


def test_splits_by_innermost_span_and_correlation_id():
    rows = trace.event_rows(EVENTS)
    out = trace.reduce_program(rows, S, S + 100 * MS, SPANS, "MainThread")
    idle = out["idle_by_program_span"]
    # gaps: 0-10 (mid 5: forward), 20-30 (mid 25: forward), 40-75 (mid
    # 57: backward), 80-90 and 95-100 (no span)
    assert idle == pytest.approx({"train.forward": 0.020,
                                  "train.backward": 0.035,
                                  trace.NO_SPAN: 0.015})
    base = trace.reduce(EVENTS, S, S + 100 * MS)
    assert sum(idle.values()) == pytest.approx(
        base["window_s"] - base["busy_s"])
    dev = out["device_by_program_span"]
    assert dev == pytest.approx({"train.forward": 0.010,
                                 "ops.resize": 0.010, trace.NO_SPAN: 0.010})
    assert sum(dev.values()) == pytest.approx(sum(base["kernels"].values()))


def test_segments_label_the_innermost_span():
    starts, ends, labels = trace.segments(SPANS[:4])
    assert list(zip((starts - S) // MS, (ends - S) // MS, labels)) == [
        (0, 2, "train.step"), (2, 11, "train.forward"),
        (11, 15, "ops.resize"), (15, 45, "train.forward"),
        (45, 60, "train.backward")]


class _Prof:
    def __init__(self, events):
        self.profiler = mock.Mock()
        self.profiler.kineto_results.events.return_value = events

    def stop(self):
        pass


def _traced(rec):
    t = trace.ProgramTracer(torch.device("cpu"), "MainThread")
    t._rec = rec
    if rec is not None:
        rec.enable()
        for s in SPANS:
            if s["thread_name"] == "MainThread":
                rec.record(s["name"], s["start_ns"], s["end_ns"],
                           **s["attrs"])
    t._prof = _Prof(EVENTS)
    t.stop(S, S + 100 * MS, [("model call", S, S + 40 * MS)])
    return t.summary


def test_existing_keys_are_unchanged_and_readers_read():
    with_spans, without = _traced(profiler), _traced(None)
    base = trace.reduce(EVENTS, S, S + 100 * MS,
                        [("model call", S, S + 40 * MS)])
    assert without == base
    assert {k: with_spans[k] for k in base} == base
    assert len(with_spans["program_spans"]) == 4
    layer = {"trace": with_spans}
    assert run.reader("train.backward_idle_pct")(layer) == pytest.approx(35)
    assert run.reader("train.forward_idle_pct")(layer) == pytest.approx(20)
    assert run.reader("train.optimizer_idle_pct")(layer) == 0.0
    assert run.reader("serve.launch_idle_pct")(layer) == 0.0
    # 80 bytes in 10 ms of device time
    assert run.reader("resize_roofline")(layer) == pytest.approx(
        100 * 80 / 3.35e12 / 0.010)
    for name in ("train.forward_idle_pct", "resize_roofline",
                 "serve.launch_idle_pct"):
        assert run.reader(name)({"trace": without}) is None
        assert run.reader(name)({"trace": None}) is None


def test_counter_readers():
    before = {"requests": 10, "queue_wait_s": 1.0, "images_run": 40,
              "images_padded": 10}
    after = {"requests": 30, "queue_wait_s": 1.5, "images_run": 140,
             "images_padded": 70}
    layer = {"before": before, "after": after}
    assert run.reader("serve.queue_ms")(layer) == pytest.approx(25.0)
    assert run.reader("serve.pad_share")(layer) == pytest.approx(60.0)
    parent = {"before": {"requests": 10}, "after": {"requests": 30}}
    assert run.reader("serve.queue_ms")(parent) is None
    assert run.reader("serve.pad_share")(parent) is None


def test_an_untraced_run_never_turns_the_recorder_on():
    with mock.patch.object(profiler, "enable",
                           side_effect=AssertionError("enabled")):
        line = run.run_cell("csf-r2n50.serve-mixed", SEED, 1.0, False, "cpu",
                            overrides=SERVE)
    assert line["correct"] and profiler.drain() == ([], 0)


def test_a_program_without_the_counters_leaves_out_only_the_new_metrics():
    from sod100k_tpu_torch import serve, serve_http

    traced = run.run_cell("csf-r2n50.serve-mixed", SEED, 1.0, True, "cpu",
                          overrides=SERVE)
    assert NEW <= set(traced["metrics"])
    snapshot = serve_http.Batcher.snapshot

    def parents(self):   # the counters the parent's batcher kept
        s = snapshot(self)
        return {k: s[k] for k in ("requests", "images", "dispatches",
                                  "batch_hist")}

    with mock.patch.object(serve_http.Batcher, "snapshot", parents), \
            mock.patch.object(serve.ServingModel, "snapshot", None,
                              create=True):
        old = run.run_cell("csf-r2n50.serve-mixed", SEED, 1.0, True, "cpu",
                           overrides=SERVE)
    assert old["correct"]
    assert set(old["metrics"]) == set(traced["metrics"]) - NEW


def test_the_probe_runs_without_the_recorder():
    with mock.patch.object(trace, "_recorder", return_value=None):
        line = pt.probe("csf-r2n50.serve-mixed", SEED, 1.0, "trace", "cpu",
                        overrides=SERVE)
    assert line["correct"]
    for name in pt.METRICS["serve"]:
        if name not in NEW:
            assert line["metrics"][name] is None
    assert "idle_by_program_span" not in line["trace"]


@pytest.mark.parametrize("workload,overrides", [
    ("csf-r2n50.serve-mixed", SERVE), ("csnet-l-x2.train-b24", TRAIN)])
def test_the_probe_reads_the_programs_spans(workload, overrides, tmp_path):
    out = tmp_path / "spans.json"
    line = pt.probe(workload, SEED, 1.0, "trace", "cpu", str(out),
                    overrides=overrides)
    assert line["correct"] and line["trace"]["spans_dropped"] == 0
    idle = line["trace"]["idle_by_program_span"]
    # no device events on the CPU: the whole window is idle
    assert sum(idle.values()) == pytest.approx(line["trace"]["window_s"])
    assert all(n == trace.NO_SPAN or n.split(".")[0] in ("batcher", "model",
                                                      "ops", "train")
               for n in idle)
    kind = "serve" if "serve" in workload else "train"
    assert all(line["metrics"][n] is not None for n in pt.METRICS[kind]
               if n != "resize_roofline")   # no device time on the CPU
    assert json.loads(out.read_text())
    recorded = pt.probe(workload, SEED, 1.0, "record", "cpu",
                        overrides=overrides)
    assert recorded["correct"] and recorded["spans_recorded"] > 0


SPAN_METRICS = {"serve.launch_idle_pct", "resize_roofline",
                "train.forward_idle_pct", "train.backward_idle_pct",
                "train.optimizer_idle_pct"}


@pytest.mark.parametrize("workload,overrides,owner_span", [
    ("csf-r2n50.serve-mixed", SERVE, "model.call"),
    ("csnet-l-x2.train-b24", TRAIN, "train.optimizer")])
def test_a_traced_run_hands_the_readers_the_programs_spans(
        workload, overrides, owner_span, monkeypatch):
    seen, plain = {}, run.reader

    def spying(name):
        read = plain(name)

        def spy(layer):
            seen[name] = layer
            return read(layer)
        return spy

    monkeypatch.setattr(run, "reader", spying)
    line = run.run_cell(workload, SEED, 1.0, True, "cpu",
                        overrides=overrides)
    bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    listed = {m["name"] for m in bench["per_layer"]
              if workload in m.get("workloads", [workload])} & SPAN_METRICS
    assert listed == ({"serve.launch_idle_pct", "resize_roofline"}
                      if "serve" in workload else SPAN_METRICS - {
                          "serve.launch_idle_pct", "resize_roofline"})
    for name in listed:
        summary = seen[name]["trace"]
        assert summary["spans_dropped"] == 0
        assert owner_span in {s["name"] for s in summary["program_spans"]}
        value = plain(name)(seen[name])
        if name == "resize_roofline":   # no device events on the CPU
            assert value is None and name not in line["metrics"]
        else:
            assert value is not None
            assert line["metrics"][name] == {"value": value, "unit": "%"}
