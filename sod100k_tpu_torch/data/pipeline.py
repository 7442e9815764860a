"""The u8 wire math, on device.

Port of ``sod100k_tpu/data/pipeline.py:29-54``. Both functions keep the JAX
package's op order, so the same inputs give the same f32 values.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def normalize_u8(image: torch.Tensor) -> torch.Tensor:
    """Raw uint8 RGB (..., 3) -> (x/255 - mean)/std in f32."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(image.device)
    std = torch.from_numpy(IMAGENET_STD).to(image.device)
    return (image.float() / 255.0 - mean) / std


def quantize_sigmoid_u8(sig: torch.Tensor) -> torch.Tensor:
    """trunc(sig * 255) as uint8: the PNG quantization applied on device."""
    return torch.trunc(sig * 255.0).to(torch.uint8)
