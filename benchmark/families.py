"""What the harness needs of each model family, keyed by the configuration
file's ``family``: the reference's parameter spec and forward, and the
port's model built from the benchmark's weights.

A configuration of a family listed here is data alone: a new file under
``benchmark/configs/``.
"""

from __future__ import annotations

import torch

from .reference import csf as ref_csf
from .reference import csnet as ref_csnet
from .reference.common import Norms, normalize_u8


class CSNetFamily:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.plan = ref_csnet.init_layers(cfg["basewidth"], cfg["split"])

    def spec(self) -> list:
        return ref_csnet.spec(self.plan)

    def forward(self, state: dict, images_u8: torch.Tensor,
                norms: Norms | None = None, tails: list | None = None):
        """uint8 NHWC -> logits (N, 1, H, W)."""
        return ref_csnet.forward(state, normalize_u8(images_u8), self.plan,
                                 norms, tails)

    def program_model(self, state: dict, device):
        from sod100k_tpu_torch.arch.csnet import CSNet
        from sod100k_tpu_torch.arch.layer_config import init_layers

        model = CSNet(init_layers(self.cfg["basewidth"], self.cfg["split"]),
                      device=device)
        model.load_state_dict(state, strict=True)
        return model


class CSFFamily:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.backbone = cfg["backbone"]

    def spec(self) -> list:
        return ref_csf.spec(self.backbone)

    def forward(self, state: dict, images_u8: torch.Tensor,
                norms: Norms | None = None, tails: list | None = None):
        return ref_csf.forward(state, normalize_u8(images_u8), self.backbone,
                               norms)

    def program_model(self, state: dict, device):
        from sod100k_tpu_torch.arch.csf_res2net import CSFNet

        model = CSFNet(self.backbone, device=device)
        model.load_state_dict(state, strict=True)
        return model


FAMILIES = {"csnet": CSNetFamily, "csf": CSFFamily}


def family(cfg: dict):
    try:
        return FAMILIES[cfg["family"]](cfg)
    except KeyError:
        raise ValueError(f"unknown model family {cfg.get('family')!r}; one "
                         f"of {sorted(FAMILIES)}") from None
