"""What the harness needs of each model family, one module a family:
``benchmark/families/<family>.py``, found by the configuration file's
``family`` key. Its ``Family(cfg)`` gives

- ``spec()``: the parameter spec ((name, shape, kind) rows) the seeded
  weights fill; ``forward(state, images_u8, norms=None)``: the plain
  reference's logits (N, 1, H, W) of uint8 NHWC images;
  ``count_forward(state, images_u8)``: one such forward, returning the
  work counts beyond FLOPs that the configuration file holds (``{}`` for
  none);
- ``program_model(state, device)``: the port's model with those weights;
  ``serving_model(state, device, workdir)``: what the HTTP daemon serves;
- training, where the family has a recipe: ``micro_steps(traffic)``, the
  calls to an optimizer step; ``program_step(model, traffic)``: (the
  port's optimizer, a call ``(image_u8, target_u8) -> loss`` through the
  port's step); ``reference_recipe(state, traffic)``, the plain recipe
  from a copy of ``state``, its trained leaves by name in ``params``; and
  ``reference_step(recipe, micro_batches, traffic)``: one optimizer step
  of it over ``micro_steps`` (image, target) pairs, as ``{"loss",
  "grads"}`` (the gradients as the optimizer got them).

A family is one new module here and its reference under
``benchmark/reference/``; a configuration of it is a new file under
``benchmark/configs/``.
"""

from __future__ import annotations

import importlib
import os
import pkgutil

import torch


def names() -> list:
    """The families there are: the modules of this package."""
    return sorted(m.name for m in pkgutil.iter_modules(__path__)
                  if not m.name.startswith("_"))


def family(cfg: dict):
    name = cfg.get("family")
    if name not in names():
        raise ValueError(f"unknown model family {name!r}; one of {names()}")
    return importlib.import_module(f"{__name__}.{name}").Family(cfg)


def artifact_model(cfg: dict, model, device, workdir: str):
    """The port's users' way to serve ``model``: ``serve.export_artifact``
    at the configuration's buckets, size, dtype and wire into ``workdir``,
    then ``serve.load_artifact``."""
    from sod100k_tpu_torch import serve

    hw = int(cfg["hw"])
    art = serve.export_artifact(
        os.path.join(workdir, "artifact"), model, batch=cfg["buckets"],
        hw=(hw, hw), dtype=getattr(torch, cfg["dtype"]), wire=cfg["wire"])
    return serve.load_artifact(art, device)
