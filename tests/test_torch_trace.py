"""The port's span recorder (``utils.profiler``) and the spans and counters
of the serving and train paths, on the CPU.

Off records nothing; spans nest per thread and ``record`` keeps intervals
timed across threads; spans share ``torch.profiler``'s clock; the batcher's
queue spans, dispatch links and ``queue_wait_s``; a served call's padding
counters and span tree down to ``ops.resize``; and the train steps give
the same numbers with the recorder on as off.
"""

import threading
import time

import numpy as np
import pytest
import torch

from sod100k_tpu_torch.arch.csf_res2net import CSFNet
from sod100k_tpu_torch.arch.csnet import CSNet
from sod100k_tpu_torch.arch.layer_config import init_layers
from sod100k_tpu_torch.serve import export_artifact, load_artifact
from sod100k_tpu_torch.serve_http import Batcher
from sod100k_tpu_torch.train import csf_step, optim, step
from sod100k_tpu_torch.utils import profiler


@pytest.fixture(autouse=True)
def _recorder_off():
    """Every test starts and ends with the recorder off and empty, on one
    torch thread (the suite's workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiler.disable()
    profiler.drain()
    yield
    profiler.disable()
    profiler.drain()
    torch.set_num_threads(n)


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_off_records_nothing():
    for i in range(10_000):
        with profiler.span("x", i=i) as s:
            assert s is None
        profiler.record("y", 0, 1)
    assert profiler.drain() == ([], 0)


def test_nesting_threads_and_record_across_threads():
    profiler.enable()
    stamps = {}

    def worker():
        with profiler.span("outer", side="worker"):
            with profiler.span("inner"):
                stamps["start"] = time.time_ns()

    with profiler.span("main") as top:
        t = threading.Thread(target=worker, name="side")
        t.start()
        t.join(30)
        assert not t.is_alive()
        # an interval that started on the worker and ends here
        profiler.record("across", stamps["start"], time.time_ns(), k=1)
    spans, dropped = profiler.drain()
    assert dropped == 0
    (main,), (outer,), (inner,), (across,) = (
        _by_name(spans, n) for n in ("main", "outer", "inner", "across"))
    assert main is top and main.parent is None
    assert outer.parent is None and inner.parent == outer.id
    assert across.parent == main.id and across.attrs == {"k": 1}
    assert outer.thread_name == "side" and main.thread_name != "side"
    assert outer.thread != main.thread and inner.thread == outer.thread
    assert main.thread == threading.get_native_id()
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert main.start_ns <= across.start_ns <= across.end_ns <= main.end_ns
    assert outer.attrs == {"side": "worker"}
    assert len({s.id for s in spans}) == 4


def test_cap_counts_dropped_spans(monkeypatch):
    monkeypatch.setattr(profiler, "SPAN_CAP", 3)
    profiler.enable()
    for _ in range(5):
        with profiler.span("x"):
            pass
    spans, dropped = profiler.drain()
    assert len(spans) == 3 and dropped == 2


def test_spans_share_the_profilers_clock():
    a = torch.randn(64, 64)
    profiler.enable()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        with profiler.span("mm"):
            torch.mm(a, a)
    (mm,) = profiler.drain()[0]
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm"]
    assert events
    for e in events:
        assert mm.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= mm.end_ns


class _SlowModel:
    """A serving model stand-in: every call takes 50 ms."""

    batches = [8]
    input_shape = (8, 4, 4, 3)
    meta = {"wire": "f32"}

    def __init__(self):
        self.called = threading.Event()

    def __call__(self, x):
        self.called.set()
        time.sleep(0.05)
        return np.zeros((x.shape[0], 4, 4, 1), np.float32)


def test_batcher_queue_spans_and_counters():
    model = _SlowModel()
    batcher = Batcher(model, max_wait_ms=1.0)
    profiler.enable()
    image = np.zeros((1, 4, 4, 3), np.float32)

    def submit():
        batcher.submit(image, timeout_s=30)

    try:
        first = threading.Thread(target=submit)
        first.start()
        assert model.called.wait(30)   # the first dispatch is running
        during = [threading.Thread(target=submit) for _ in range(3)]
        for t in during:
            t.start()
        for t in [first, *during]:
            t.join(30)
            assert not t.is_alive()
        stats = batcher.snapshot()
    finally:
        batcher.stop()
    spans, _ = profiler.drain()
    queue = _by_name(spans, "batcher.queue")
    assert len(queue) == 4
    ids = {s.attrs["request"] for s in queue}
    assert len(ids) == 4 and all(s.attrs["images"] == 1 for s in queue)
    dispatch = _by_name(spans, "batcher.dispatch")
    assert len(dispatch) == 2 and stats["dispatches"] == 2
    late = dispatch[1].attrs["requests"]
    assert len(late) == 3 and set(late) < ids
    # the three submitted during the first dispatch waited for it
    for s in queue:
        if s.attrs["request"] in late:
            assert s.end_ns - s.start_ns > 10e6
    assert len(_by_name(spans, "batcher.window")) == 2
    assert stats["queue_wait_s"] == pytest.approx(
        sum(s.end_ns - s.start_ns for s in queue) / 1e9, rel=1e-9)
    assert 0.0 <= stats["drain_s"] < 1.0
    assert stats["requests"] == 4 and stats["images"] == 4


HW = (32, 32)


def test_served_call_counts_padding_and_nests_its_spans(tmp_path):
    model = CSNet(init_layers(8, (0.5, 0.5)), seed=2, device="cpu")
    export_artifact(str(tmp_path), model, batch=(1, 8), hw=HW,
                    dtype=torch.float32, wire="u8")
    sm = load_artifact(str(tmp_path), device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (3, *HW, 3),
                                               np.uint8)
    profiler.enable()
    out = sm(images)
    spans, _ = profiler.drain()
    assert out.shape == (3, *HW, 1)
    assert sm.snapshot() == {"images_run": 8, "images_padded": 5,
                             "bucket_runs": {8: 1}}
    (call,) = _by_name(spans, "model.call")
    assert call.attrs == {"images": 3, "padded": 5}
    children = {s.name: s for s in spans if s.parent == call.id}
    assert set(children) == {"model.pad", "model.h2d", "model.forward",
                             "model.readback"}
    forward = children["model.forward"]
    resizes = _by_name(spans, "ops.resize")
    assert resizes and all(s.parent == forward.id for s in resizes)
    for s in resizes:
        assert s.attrs["itemsize"] == 4
        assert s.attrs["shape"][:2] == s.attrs["out_shape"][:2]
        assert s.attrs["shape"][2:] != s.attrs["out_shape"][2:]
    assert all(s.thread == call.thread for s in spans)


def _csnet_step():
    model = CSNet(init_layers(8, (0.5, 0.5)), seed=4, device="cpu")
    opt = optim.make_adam_dwd(model, weight_decay=5e-3)
    run = step.make_train_step(model, opt, flops_weight=3.0, batch_size=2,
                               from_u8=True)
    return model, lambda b: run(b, 1e-3, 1.0)["loss"]


def _csf_step():
    model = CSFNet("res2net50", seed=4, device="cpu")
    csf_step.freeze_reference_params(model)
    opt = csf_step.make_csf_optimizer(model)
    run = csf_step.CSFTrainStep(model, opt, iter_size=1, batch_size=2,
                                from_u8=True)
    return model, lambda b: run(b, 1e-3)["loss"]


@pytest.mark.parametrize("make", [_csnet_step, _csf_step],
                         ids=["csnet", "csf"])
def test_train_step_spans_change_no_number(make):
    rng = np.random.default_rng(3)
    batch = {"image": torch.from_numpy(
                 rng.integers(0, 256, (2, *HW, 3), np.uint8)),
             "target": torch.from_numpy(
                 (rng.random((2, *HW, 1)) > 0.5).astype(np.uint8) * 255)}
    runs = []
    for on in (False, True):
        if on:
            profiler.enable()
        model, run = make()
        losses = [float(run(batch)) for _ in range(2)]
        runs.append((losses, {n: p.detach().clone()
                              for n, p in model.named_parameters()}))
        profiler.disable()
    (off_loss, off_p), (on_loss, on_p) = runs
    assert off_loss == on_loss
    assert all(torch.equal(off_p[n], on_p[n]) for n in off_p)
    spans, _ = profiler.drain()
    steps = _by_name(spans, "train.step")
    assert len(steps) == 2
    for st in steps:
        kids = sorted((s for s in spans if s.parent == st.id),
                      key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["train.forward", "train.backward",
                                          "train.optimizer"]
