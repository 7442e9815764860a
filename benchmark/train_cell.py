"""A training cell: the port's train step, on batches resident on the card.

Set-up builds one train step (the model with the benchmark's weights, its
optimizer) and drives it through its first ``CHECK_STEPS`` optimizer
steps on the first batches, through the same call and feed as the window;
those steps' losses, the first gradient as the optimizer got it and the
parameters after them are kept. The window then goes on with the same
object over the ``resident_batches`` seeded uint8 batches in turn. After
it, the reference takes the same steps from the same weights and batches.

Families: ``csnet`` runs ``train.step.make_train_step`` with the recipe's
Adam (``train.optim.make_adam_dwd``) and the BN-gamma penalty; ``csf``
runs ``train.csf_step.CSFTrainStep`` (``iter_size`` micro-steps to an
optimizer step).
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from . import check, roofline, weights
from .families import family
from .reference.common import tf32
from .reference.train import CSFRecipe, CSNetRecipe
from .trace import Tracer

CHECK_STEPS = 3


def make_batches(seed: int, n: int, batch: int, hw: int, device):
    """``n`` batches of uint8 images (noise) and uint8 targets (smooth
    blobs, 0 or 255), drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    images = torch.randint(0, 256, (n, batch, hw, hw, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    low = torch.rand((n * batch, 1, hw // 16, hw // 16), generator=gen,
                     device=device)
    blobs = F.interpolate(low, size=(hw, hw), mode="bilinear",
                          align_corners=False) > 0.5
    targets = (blobs.to(torch.uint8) * 255).view(n, batch, 1, hw, hw)
    return images, targets.permute(0, 1, 3, 4, 2).contiguous()


class _Program:
    """The port's step for a family, and how to read its state."""

    def __init__(self, fam, cfg: dict, traffic: dict, state: dict, device):
        from sod100k_tpu_torch.train import csf_step, optim, step

        self.model = fam.program_model(state, device)
        self.traffic = traffic
        t = traffic
        if cfg["family"] == "csnet":
            self.opt = optim.make_adam_dwd(self.model,
                                           weight_decay=t["weight_decay"])
            self.step = step.make_train_step(
                self.model, self.opt, flops_weight=t["penalty_weight"],
                flops_expand=t["penalty_expand"], batch_size=t["batch"],
                from_u8=True)
            self.micro = 1
        else:
            csf_step.freeze_reference_params(self.model)
            self.opt = csf_step.make_csf_optimizer(
                self.model, weight_decay=t["weight_decay"])
            self.step = csf_step.CSFTrainStep(
                self.model, self.opt, iter_size=t["iter_size"],
                batch_size=t["batch"], from_u8=True)
            self.micro = t["iter_size"]
        self.family = cfg["family"]

    def __call__(self, image, target) -> torch.Tensor:
        batch = {"image": image, "target": target}
        if self.family == "csnet":
            out = self.step(batch, self.traffic["lr"], 1.0)
            return out["loss"] + self.traffic["penalty_weight"] \
                * out["penalty"]
        return self.step(batch, self.traffic["lr"])["loss"]

    def first_moments(self) -> dict:
        """Each trained leaf's first gradient as the optimizer got it, from
        its first moment after one step (zero for a leaf it never
        stepped)."""
        b1 = self.opt.param_groups[0]["betas"][0]
        out = {}
        for n, p in self.model.named_parameters():
            if p.requires_grad:
                m = self.opt.state.get(p, {}).get("exp_avg")
                out[n] = (torch.zeros_like(p) if m is None
                          else m.detach().clone() / (1 - b1))
        return out

    def params(self) -> dict:
        return {n: p.detach().clone()
                for n, p in self.model.named_parameters() if p.requires_grad}


def _reference(fam, cfg, traffic, state, images, targets, steps: int):
    t = traffic
    if cfg["family"] == "csnet":
        rec = CSNetRecipe(state, fam.plan, batch=t["batch"],
                          penalty_weight=t["penalty_weight"],
                          expand=t["penalty_expand"],
                          weight_decay=t["weight_decay"])
    else:
        rec = CSFRecipe(state, fam.backbone, batch=t["batch"],
                        iter_size=t["iter_size"],
                        weight_decay=t["weight_decay"])
    p0 = {k: v.clone() for k, v in rec.params.items()}
    losses, grad, k = [], None, 0
    for s in range(steps):
        if cfg["family"] == "csnet":
            out = rec.step(images[k], targets[k], t["lr"])
            losses.append(out["loss"] + t["penalty_weight"] * out["penalty"])
            k += 1
        else:
            micro = [(images[k + i], targets[k + i])
                     for i in range(t["iter_size"])]
            out = rec.step(micro, t["lr"])
            losses.append(out["loss"])
            k += t["iter_size"]
        if s == 0:
            grad = out["grads"]
    return {"losses": losses, "grad": grad,
            "change": {n: rec.params[n] - p0[n] for n in p0}}


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, log) -> dict:
    fam = family(cfg)
    hw, batch = int(cfg["hw"]), int(traffic["batch"])
    n_batches = int(traffic["resident_batches"])
    steps = CHECK_STEPS
    state = weights.seeded_state(fam.spec(), seed, device)
    images, targets = make_batches(seed, n_batches, batch, hw, device)
    weights.calibrate(fam, state, images[0])

    prog = _Program(fam, cfg, traffic, state, device)
    p0 = prog.params()
    losses, grad, k, loss = [], None, 0, None
    for s in range(steps):
        total = 0.0
        for _ in range(prog.micro):
            total += float(prog(images[k], targets[k]))
            k += 1
        losses.append(total)
        if s == 0:
            grad = prog.first_moments()
    change = {n: v - p0[n] for n, v in prog.params().items()}
    readings = {"losses": losses, "grad": grad, "change": change}

    tracer = Tracer(device) if trace else None
    if tracer:
        tracer.start()
    _sync(device)
    setup_s = time.monotonic() - t_start
    t0, t0_ns = time.monotonic(), time.time_ns()
    micro_steps = 0
    while True:
        j = (k + micro_steps) % n_batches
        loss = prog(images[j], targets[j])
        micro_steps += 1
        if time.monotonic() - t0 >= seconds and \
                micro_steps % prog.micro == 0:
            break
    _sync(device)
    window = time.monotonic() - t0
    if tracer:
        tracer.stop(t0_ns, time.time_ns())
    last_loss = float(loss)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del prog
    if device.type == "cuda":
        torch.cuda.empty_cache()

    with tf32(False):
        ref = _reference(fam, cfg, traffic, state, images, targets, steps)
    numbers = check.train_numbers(readings, ref)
    ok, checks = check.verdict(numbers, traffic["limits"])
    ok = ok and torch.isfinite(torch.tensor(last_loss)).item()
    log(f"# window: {micro_steps} micro-steps of {batch} images in "
        f"{window:.3f} s; losses program {losses} reference {ref['losses']}")
    imgs = micro_steps * batch
    return {
        "correct": ok, "attempted": micro_steps, "failed": 0,
        "e2e": {"setup_s": setup_s, "train_img_per_s": imgs / window},
        "peak": peak, "checks": checks,
        "layer": {"images": imgs, "window_s": window,
                  "flops_per_img": cfg["flops_per_img"],
                  "peak_flops": roofline.peak_flops(cfg),
                  "trace": tracer.summary if tracer else None}}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
