"""Seeded weights, made on the device in a few large calls.

Every convolution weight (and the classifier's bias) is drawn uniform in
+-1/sqrt(fan_in), torch's default convolution init; norms start at weight
1, bias 0; PReLU slopes at 0.25. Then one seeded batch through the
reference in calibration mode sets every batch norm's running statistics
to that batch's (mean, unbiased variance), as a model trained on such
images would hold: with the init statistics (0, 1) CSNet's x100
convolutions saturate its maps. The same state dict goes to the port and
to the reference.
"""

from __future__ import annotations

import math

import torch

from .reference.common import Norms, tf32

CALIBRATE_IMAGES = 4

_CONST = {"norm_weight": 1.0, "norm_bias": 0.0, "mean": 0.0, "var": 1.0,
          "prelu": 0.25}


def seeded_state(spec: list, seed: int, device) -> dict:
    """The state dict of ``spec`` ((name, shape, kind) rows), drawn from
    ``seed`` on ``device``."""
    shapes = {name: shape for name, shape, _ in spec}
    drawn = [(n, s, k) for n, s, k in spec if k in ("conv", "goct",
                                                    "conv_bias")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    state, off = {}, 0
    for name, shape, kind in drawn:
        n = math.prod(shape)
        weight = shapes[name.rsplit(".", 1)[0] + ".weight"] \
            if kind == "conv_bias" else shape
        bound = math.prod(weight[1:]) ** -0.5
        state[name] = flat[off:off + n].view(shape) * bound
        off += n
    for name, shape, kind in spec:
        if kind == "count":
            state[name] = torch.zeros((), dtype=torch.int64, device=device)
        elif kind in _CONST:
            state[name] = torch.full(shape, _CONST[kind], device=device)
    return state


@torch.no_grad()
def calibrate(fam, state: dict, images_u8) -> dict:
    """Set the running statistics of every batch norm the forward meets
    from the first ``CALIBRATE_IMAGES`` of ``images_u8`` (uint8 NHWC, numpy
    or a tensor), through ``fam.forward`` in calibration mode, in float32
    with TF32 off whatever the program's flags; returns ``state``."""
    device = next(iter(state.values())).device
    x = torch.as_tensor(images_u8[:CALIBRATE_IMAGES]).to(device)
    norms = Norms("calibrate")
    with tf32(False):
        fam.forward(state, x, norms)
    for name, (mean, var) in norms.stats.items():
        state[name + ".running_mean"] = mean.contiguous()
        state[name + ".running_var"] = var.contiguous()
    return state
