"""Params/FLOPs counts, a profiler trace and wall-clock meters.

Port of ``sod100k_tpu/utils/profiler.py``. The reference counts params and
FLOPs with forward hooks and every driver prints both at startup
(train.py:93-96); the JAX package counts XLA's compiled FLOPs. Here
``simplesum`` counts with ``torch.utils.flop_counter.FlopCounterMode``
(the FLOPs of the convolutions and matmuls that one forward dispatches),
another count than XLA's, so the drivers' startup line names
``FLOP_COUNTER``. ``count_params`` equals the JAX package's count.

Also: a ``torch.profiler`` trace written as a Chrome trace, and the span
recorder the serving and train paths report to.

Spans. ``span(name, **attrs)`` brackets a block, ``record(name, start_ns,
end_ns, **attrs)`` keeps an interval timed elsewhere (one that starts on
one thread and ends on another). Each span keeps its name, its bounds from
``time.time_ns()`` (the Unix epoch, as ``torch.profiler``'s timestamps,
so spans line up with a device trace), its OS thread id and name, its own
id, its parent's id (the innermost span open on its thread) and its
attributes. Recording is off by default, and then a span site costs one
check of a module global: no clock read and no stack push; ``with
span(...) as s`` binds None, so a site computes costly attributes only
under ``if s is not None``. ``enable()`` turns recording on for the
process, ``disable()`` off; spans stay in memory, at most ``SPAN_CAP``
(``dropped`` counts the rest), until ``drain()`` hands them over.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import os
import threading
import time

import torch
from torch import nn

FLOP_COUNTER = "torch.utils.flop_counter"


def count_params(model: nn.Module) -> int:
    """``arch.csnet.count_params``: the parameter count without BN running
    statistics (imported at the call, since the ops import this module's
    spans)."""
    from ..arch.csnet import count_params as count

    return count(model)


def simplesum(model: nn.Module, inputsize=(224, 224, 3)) -> tuple[int, float]:
    """Reference ``simplesum(model, inputsize, device)`` facade
    (model/utils/simplesum_octconv.py:5-8): (n_params, FLOPs) of a batch-1
    eval forward at ``inputsize`` (H, W, C), counted on a CPU copy of the
    model (on the card the fused depthwise tail is a kernel call that the
    counter cannot see)."""
    from torch.utils.flop_counter import FlopCounterMode

    cpu = copy.deepcopy(model).to("cpu").eval()
    x = torch.zeros((1, *inputsize), dtype=torch.float32)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        cpu(x)
    return count_params(model), float(counter.get_total_flops())


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace (host, and the card when there is one) of
    the block, written to ``log_dir`` as a Chrome trace (chrome://tracing,
    Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.strftime('%Y_%m_%d-%H_%M_%S')}.json"))


SPAN_CAP = 1 << 18

_on = False          # the one check a span site makes while recording is off
_spans: list = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def _thread_stack() -> list:
    """The calling thread's open spans, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        _local.ident = (threading.get_native_id(),
                        threading.current_thread().name)
        return _local.stack


def _keep(s: "Span") -> None:
    global _dropped
    with _lock:
        if len(_spans) < SPAN_CAP:
            _spans.append(s)
        else:
            _dropped += 1


class Span:
    """One recorded interval (see the module's docstring)."""

    __slots__ = ("name", "start_ns", "end_ns", "thread", "thread_name",
                 "id", "parent", "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.start_ns = self.end_ns = 0

    def _open(self) -> list:
        stack = _thread_stack()
        self.thread, self.thread_name = _local.ident
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        return stack

    def __enter__(self) -> "Span":
        self._open().append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        _local.stack.pop()
        _keep(self)
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class _Off:
    """What ``span`` returns while recording is off: binds None."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """A context manager that records the block as span ``name`` while
    recording is on; binds the ``Span`` (None while off)."""
    if not _on:
        return _OFF
    return Span(name, attrs)


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Keep span ``name`` over [start_ns, end_ns] (``time.time_ns()``
    readings, taken anywhere), on the calling thread and under its
    innermost open span, while recording is on."""
    if not _on:
        return
    s = Span(name, attrs)
    s._open()
    s.start_ns, s.end_ns = start_ns, end_ns
    _keep(s)


def enable() -> None:
    """Start recording (dropping whatever an earlier recording left), at
    most ``SPAN_CAP`` spans until the next ``drain``."""
    global _on
    drain()
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> tuple[list, int]:
    """(the spans recorded since the last drain, in the order they ended,
    the number dropped over the cap); both start again from empty."""
    global _spans, _dropped
    with _lock:
        out, dropped = _spans, _dropped
        _spans, _dropped = [], 0
    return out, dropped


__all__ = ["FLOP_COUNTER", "SPAN_CAP", "Span", "count_params", "disable",
           "drain", "enable", "record", "simplesum", "span", "trace"]
