"""Count a configuration's work per image, on the CPU, from the reference.

    python -m benchmark.counts benchmark/configs/<config>.json

Prints the counts as JSON: ``flops_per_img``, the FLOPs of one image's
forward at the configuration's size as ``torch.utils.flop_counter``
counts them (convolutions and matrix products; norms, activations and
resizes are not counted), and for CSNet ``dw_chain``, the fused
depthwise tail's bytes and operations per image from the shapes of its
tails in that forward (``roofline.dw_chain_work``). The configuration
files hold these numbers; ``tests/test_benchmark_counts.py`` counts them
again.
"""

from __future__ import annotations

import json
import sys

import torch

from . import roofline
from .families import family
from .reference.common import fill_spec


def count(cfg: dict) -> dict:
    from torch.utils.flop_counter import FlopCounterMode

    fam = family(cfg)
    state = fill_spec(fam.spec(), {})
    hw = int(cfg["hw"])
    x = torch.zeros((1, hw, hw, 3), dtype=torch.uint8)
    tails: list = []
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fam.forward(state, x, tails=tails)
    out = {"flops_per_img": int(counter.get_total_flops())}
    if cfg["family"] == "csnet":
        out["dw_chain"] = roofline.dw_chain_work(
            [tuple(s[1:]) for s in tails])
    return out


def main(argv=None) -> None:
    for path in (argv if argv is not None else sys.argv[1:]):
        with open(path) as f:
            print(json.dumps({path: count(json.load(f))}))


if __name__ == "__main__":
    main()
