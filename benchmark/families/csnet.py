"""CSNet (any width and split): the reference ``reference.csnet``, the
port's ``arch.csnet.CSNet``; trained by the recipe's step
(``train.step.make_train_step``, Adam-dwd, the BN-gamma penalty), held to
``reference.train.CSNetRecipe``. Its extra counts are the fused depthwise
tail's (``dw_chain``)."""

from __future__ import annotations

import torch

from .. import roofline
from ..reference import csnet as ref_csnet
from ..reference.common import Norms, normalize_u8
from ..reference.train import CSNetRecipe
from . import artifact_model


class Family:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.plan = ref_csnet.init_layers(cfg["basewidth"], cfg["split"])

    def spec(self) -> list:
        return ref_csnet.spec(self.plan)

    def forward(self, state: dict, images_u8: torch.Tensor,
                norms: Norms | None = None, tails: list | None = None):
        """uint8 NHWC -> logits (N, 1, H, W); ``tails`` collects the
        shapes of the fused tail's launches."""
        return ref_csnet.forward(state, normalize_u8(images_u8), self.plan,
                                 norms, tails)

    def count_forward(self, state: dict, images_u8: torch.Tensor) -> dict:
        tails: list = []
        self.forward(state, images_u8, tails=tails)
        return {"dw_chain": roofline.dw_chain_work(
            [tuple(s[1:]) for s in tails])}

    def program_model(self, state: dict, device):
        from sod100k_tpu_torch.arch.csnet import CSNet
        from sod100k_tpu_torch.arch.layer_config import init_layers

        model = CSNet(init_layers(self.cfg["basewidth"], self.cfg["split"]),
                      device=device)
        model.load_state_dict(state, strict=True)
        return model

    def serving_model(self, state: dict, device, workdir: str):
        return artifact_model(self.cfg, self.program_model(state, device),
                              device, workdir)

    def micro_steps(self, traffic: dict) -> int:
        return 1

    def program_step(self, model, traffic: dict):
        """Adam-dwd and the recipe's step with the penalty on; the loss is
        BCE + weight * penalty."""
        from sod100k_tpu_torch.train import optim, step

        t = traffic
        opt = optim.make_adam_dwd(model, weight_decay=t["weight_decay"])
        run = step.make_train_step(
            model, opt, flops_weight=t["penalty_weight"],
            flops_expand=t["penalty_expand"], batch_size=t["batch"],
            from_u8=True)

        def call(image, target) -> torch.Tensor:
            out = run({"image": image, "target": target}, t["lr"], 1.0)
            return out["loss"] + t["penalty_weight"] * out["penalty"]

        return opt, call

    def reference_recipe(self, state: dict, traffic: dict) -> CSNetRecipe:
        t = traffic
        return CSNetRecipe(state, self.plan, batch=t["batch"],
                           penalty_weight=t["penalty_weight"],
                           expand=t["penalty_expand"],
                           weight_decay=t["weight_decay"])

    def reference_step(self, recipe: CSNetRecipe, micro_batches,
                       traffic: dict) -> dict:
        (image, target), = micro_batches
        out = recipe.step(image, target, traffic["lr"])
        return {"loss": out["loss"]
                + traffic["penalty_weight"] * out["penalty"],
                "grads": out["grads"]}
