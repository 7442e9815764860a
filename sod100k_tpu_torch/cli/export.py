"""Serving-artifact export driver (the port of ``cli/export.py``).

Usage:
  python -m sod100k_tpu_torch.cli.export --config <yml> --out <dir>
      [--batch N[,N...]] [--dtype bf16|f32] [--wire f32|u8]
      exports the CSNet model named by TEST.MODEL_CONFIG/TEST.CHECKPOINT at
      TEST.IMAGE_H/W (224 when the config uses the ceil-to-16 mode).
  python -m sod100k_tpu_torch.cli.export --family csf --model <ckpt>
      --arch res2net50 --out <dir> [--size 336]

The artifact (``serve.export_artifact``: meta.json, the f32 state_dict and,
for CSNet, the layer config) loads with ``serve.load_artifact`` and serves
through ``python -m sod100k_tpu_torch.cli.serve``.
"""

from __future__ import annotations

import argparse

import torch

from ..arch.layer_config import LayerConfig
from ..config import get_cfg
from ..data.pipeline import require_device
from ..interop.torch_ckpt import load_pretrained
from ..serve import export_artifact
from .common import load_any_checkpoint


def run_export(args, *, device: str | torch.device = "cuda") -> str:
    """Build the model of ``args`` (the parsed command line) on ``device``
    with its checkpoint's weights and write the artifact."""
    device = require_device(device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    batch = [int(b) for b in str(args.batch).split(",")]
    if args.family == "csnet":
        from ..arch.csnet import CSNet

        if not args.config:
            raise SystemExit("--config required for csnet export")
        cfg = get_cfg()
        cfg.merge_from_file(args.config)
        model = CSNet(LayerConfig.load(cfg.TEST.MODEL_CONFIG), device=device)
        load_any_checkpoint(cfg.TEST.CHECKPOINT, model)
        hw = (cfg.TEST.IMAGE_H or 224, cfg.TEST.IMAGE_W or 224)
    else:
        from ..arch.csf_res2net import CSFNet

        if not args.model:
            raise SystemExit("--model required for csf export")
        # the seeded init under the checkpoint's tensors (the JAX driver's
        # merge of the loaded tree over a fresh init)
        model = CSFNet(args.arch, device=device)
        load_pretrained(model, args.model)
        hw = (args.size, args.size)
    return export_artifact(args.out, model, batch=batch, hw=hw, dtype=dtype,
                           wire=args.wire)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="export a serving artifact")
    ap.add_argument("--config", default=None, metavar="FILE",
                    help="CSNet yml (uses TEST.MODEL_CONFIG/CHECKPOINT)")
    ap.add_argument("--family", default="csnet", choices=["csnet", "csf"])
    ap.add_argument("--model", default=None, help="csf checkpoint path")
    ap.add_argument("--arch", default="res2net50",
                    choices=["res2net50", "res2net101"])
    ap.add_argument("--size", type=int, default=336, help="csf input size")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", default="1",
                    help="batch size or comma list of bucket sizes "
                         "(e.g. 1,32,128); the loaded model routes any "
                         "request batch onto the buckets")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--wire", default="f32", choices=["f32", "u8"],
                    help="u8 = raw uint8 RGB in (normalize fused) and "
                         "trunc(sigmoid*255) uint8 out; 4x less traffic "
                         "both ways")
    out = run_export(ap.parse_args(argv))
    print(f"exported serving artifact to {out}")


if __name__ == "__main__":
    main()
