"""The CSNet eval step.

Port of ``sod100k_tpu/train/step.py:103-131`` (``make_eval_step``). The
train step is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..data.pipeline import normalize_u8, quantize_sigmoid_u8


def make_eval_step(model: nn.Module, *, from_u8: bool = False,
                   compute_dtype: torch.dtype | None = None,
                   quantize_u8: bool = False):
    """Inference step: NHWC image batch -> sigmoid saliency maps (N,H,W,1).

    Puts ``model`` in eval mode. Images move to the model's device.
    ``from_u8`` takes raw uint8 RGB and normalizes on device;
    ``compute_dtype`` casts the normalized image (activations run in that
    dtype, parameters stay f32 and are cast per op); ``quantize_u8`` returns
    trunc(sigmoid*255) as uint8, otherwise the f32 sigmoid.
    """
    model.eval()
    device = next(model.parameters()).device

    @torch.inference_mode()
    def step(image: torch.Tensor) -> torch.Tensor:
        image = image.to(device)
        if from_u8:
            image = normalize_u8(image)
        if compute_dtype is not None:
            image = image.to(compute_dtype)
        sig = torch.sigmoid(model(image).float())
        return quantize_sigmoid_u8(sig) if quantize_u8 else sig

    return step
