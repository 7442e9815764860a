"""Count a configuration's work per image, on the CPU, from the reference.

    python -m benchmark.counts benchmark/configs/<config>.json

Prints the counts as JSON: ``flops_per_img``, the FLOPs of one image's
forward at the configuration's size as ``torch.utils.flop_counter``
counts them (convolutions and matrix products; norms, activations and
resizes are not counted), and whatever further counts the family's
``count_forward`` returns from that forward (CSNet: ``dw_chain``, the
fused depthwise tail's bytes and operations per image). The
configuration files hold these numbers; ``tests/test_benchmark_counts.py``
counts them again.
"""

from __future__ import annotations

import json
import sys

import torch

from .families import family
from .reference.common import fill_spec


def count(cfg: dict) -> dict:
    from torch.utils.flop_counter import FlopCounterMode

    fam = family(cfg)
    state = fill_spec(fam.spec(), {})
    hw = int(cfg["hw"])
    x = torch.zeros((1, hw, hw, 3), dtype=torch.uint8)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        extra = fam.count_forward(state, x)
    return {"flops_per_img": int(counter.get_total_flops()), **extra}


def main(argv=None) -> None:
    for path in (argv if argv is not None else sys.argv[1:]):
        with open(path) as f:
            print(json.dumps({path: count(json.load(f))}))


if __name__ == "__main__":
    main()
