"""Params/FLOPs counts, a profiler trace and wall-clock meters.

Port of ``sod100k_tpu/utils/profiler.py``. The reference counts params and
FLOPs with forward hooks and every driver prints both at startup
(train.py:93-96); the JAX package counts XLA's compiled FLOPs. Here
``simplesum`` counts with ``torch.utils.flop_counter.FlopCounterMode``
(the FLOPs of the convolutions and matmuls that one forward dispatches),
another count than XLA's, so the drivers' startup line names
``FLOP_COUNTER``. ``count_params`` equals the JAX package's count.

Also: a ``torch.profiler`` trace written as a Chrome trace, and the
AverageMeter and Timer the drivers use for their prints.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time

import torch
from torch import nn

from ..arch.csnet import count_params

FLOP_COUNTER = "torch.utils.flop_counter"


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


class AverageMeter:
    """Running value/average (reference train.py:333-348)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class Timer:
    """Context-manager wall clock for FPS prints."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dt = time.perf_counter() - self.t0
        return False


__all__ = ["FLOP_COUNTER", "AverageMeter", "Timer", "count_params",
           "simplesum", "trace"]
