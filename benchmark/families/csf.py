"""CSF+Res2Net (``backbone`` res2net50 or res2net101): the reference
``reference.csf``, the port's ``arch.csf_res2net.CSFNet``; trained by the
Solver's step (``train.csf_step.CSFTrainStep``: ``iter_size`` micro-steps
to an Adam step, the reference's frozen parameters frozen), held to
``reference.train.CSFRecipe``. No extra counts."""

from __future__ import annotations

import torch

from ..reference import csf as ref_csf
from ..reference.common import Norms, normalize_u8
from ..reference.train import CSFRecipe
from . import artifact_model


class Family:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.backbone = cfg["backbone"]

    def spec(self) -> list:
        return ref_csf.spec(self.backbone)

    def forward(self, state: dict, images_u8: torch.Tensor,
                norms: Norms | None = None):
        return ref_csf.forward(state, normalize_u8(images_u8), self.backbone,
                               norms)

    def count_forward(self, state: dict, images_u8: torch.Tensor) -> dict:
        self.forward(state, images_u8)
        return {}

    def program_model(self, state: dict, device):
        from sod100k_tpu_torch.arch.csf_res2net import CSFNet

        model = CSFNet(self.backbone, device=device)
        model.load_state_dict(state, strict=True)
        return model

    def serving_model(self, state: dict, device, workdir: str):
        return artifact_model(self.cfg, self.program_model(state, device),
                              device, workdir)

    def micro_steps(self, traffic: dict) -> int:
        return int(traffic["iter_size"])

    def program_step(self, model, traffic: dict):
        """The Solver's Adam over the parameters it trains, and
        ``CSFTrainStep``; the loss is the micro-step's share."""
        from sod100k_tpu_torch.train import csf_step

        t = traffic
        csf_step.freeze_reference_params(model)
        opt = csf_step.make_csf_optimizer(model,
                                          weight_decay=t["weight_decay"])
        run = csf_step.CSFTrainStep(model, opt, iter_size=t["iter_size"],
                                    batch_size=t["batch"], from_u8=True)

        def call(image, target) -> torch.Tensor:
            return run({"image": image, "target": target}, t["lr"])["loss"]

        return opt, call

    def reference_recipe(self, state: dict, traffic: dict) -> CSFRecipe:
        t = traffic
        return CSFRecipe(state, self.backbone, batch=t["batch"],
                         iter_size=t["iter_size"],
                         weight_decay=t["weight_decay"])

    def reference_step(self, recipe: CSFRecipe, micro_batches,
                       traffic: dict) -> dict:
        out = recipe.step(micro_batches, traffic["lr"])
        return {"loss": out["loss"], "grads": out["grads"]}
