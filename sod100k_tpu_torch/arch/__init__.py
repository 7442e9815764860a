"""Architecture registry.

Port of ``sod100k_tpu/arch/__init__.py``. The reference resolves
MODEL.ARCH dynamically (importlib.import_module("model." + cfg.MODEL.ARCH),
train.py:70); here the same string selects a ``build(lc, *, device,
seed=0)`` that returns the ``nn.Module`` on an explicit device. Custom
architectures register with :func:`register_arch`.
"""

from __future__ import annotations

from typing import Callable

from .layer_config import LayerConfig, init_layers

_REGISTRY: dict[str, Callable] = {}


def register_arch(name: str, build: Callable) -> None:
    _REGISTRY[name] = build


def get_arch(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown MODEL.ARCH {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def _csnet(lc: LayerConfig, *, device, seed: int = 0):
    from .csnet import CSNet

    return CSNet(lc, seed=seed, device=device)


def _csf(backbone: str):
    # CSF models ignore the layer_config argument (fixed backbone widths)
    def build(lc=None, *, device, seed: int = 0):
        from .csf_res2net import CSFNet

        return CSFNet(backbone, seed=seed, device=device)

    return build


register_arch("csnet", _csnet)
for _backbone in ("res2net50", "res2net101"):
    register_arch(f"csf_{_backbone}", _csf(_backbone))

__all__ = ["LayerConfig", "get_arch", "init_layers",
           "register_arch"]
