"""CSNet as an ``nn.Module`` (NCHW inside, NHWC at the edges).

Port of ``sod100k_tpu/arch/csnet.py:41-220``: a stage0 stem ILBlock, four
stages of ILBlocks ([3,4,6,4] by default, stride 2 opening stages 2-4), a
Cross-Stage-Fusion head over the branch-0 outputs of stages 2/3/4 treated as
a 3-octave set, a 1x1 classifier and a bilinear resize back to the input
size.

Module names reproduce the reference state_dict keys
(``stage1.0.conv1x1.conv.weight``, ``oct_fuse.ms.convs.0.msconv.2.weight``,
``cls_layer.bias``), so reference checkpoints and the JAX package's
parameters (through ``interop.torch_ckpt``) load with ``strict=True``.

In eval mode each ILBlock's depthwise tail runs fused
(``ops.dw_chain.dw_tail_fused``): the CUDA kernel on the card, its plain
version on the CPU, from parameter packs that the block builds once per
weight set (``ops.dw_chain.TailPacks``). Train mode runs the unfused
modules, which own the parameters; only a train-mode forward collects the
dynamic-weight-decay signal (``ops.goct.GapCollector``), as the JAX package
never routes a collecting forward through the kernel.

The model builds on the card unless the caller names another device.

``forward(x, gap, spatial=ctx)`` runs on row bands under a 2-D mesh
(``parallel.spatial``): ``x`` is this rank's band of the images' rows and
the result its band of the logits; every spatial op fetches the rows it
reads from the other ranks of the spatial group, and the eval tail runs
the kernel on band + halo (``ops.dw_chain.fused_dw_chain_band``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.conv import ConvWeight, conv2d, init_conv_
from ..ops.dw_chain import TailPacks, dw_tail_fused
from ..ops.goct import GapCollector, GOctCBR, PallMSBlock, SimplifiedGOctCBR
from ..ops.resample import resize_bilinear
from ..parallel.spatial import SpatialCtx, tag
from .layer_config import BlockPlan, Entry, LayerConfig

STAGES = ("stage0", "stage1", "stage2", "stage3", "stage4")
# the downsampling at the input of the deepest true strided conv: stages
# 2-4 open with stride-2 single-branch CBRs, so the stage-4 opener sees
# H/4 (``sod100k_tpu/arch/csnet.py:34``); the 2-D mesh's extent check
# keys off it (``parallel.mesh.check_spatial_extent``)
DEEPEST_STRIDE2_FACTOR = 4


class ILBlock(nn.Module):
    """Leading gOctConv CBR + two depthwise simplified CBRs."""

    def __init__(self, entry: Entry, plan: BlockPlan, *, device=None):
        super().__init__()
        self.split = entry.out_split
        self.conv1x1 = GOctCBR(entry.in_split, entry.out_split, plan.kernel,
                               stride=plan.stride, padding=plan.padding,
                               device=device)
        self.conv3x3_1 = SimplifiedGOctCBR(entry.out_split, device=device)
        self.conv3x3_2 = SimplifiedGOctCBR(entry.out_split, device=device)
        self.tail_packs = TailPacks()

    # A move or conversion gives the buffers fresh tensors whose version
    # counters restart, possibly at freed addresses, so the packs' key
    # could repeat for new data: drop the packs instead.
    def _apply(self, *args, **kwargs):
        self.tail_packs = TailPacks()
        return super()._apply(*args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self.tail_packs = TailPacks()
        super()._load_from_state_dict(*args, **kwargs)

    def forward(self, xset: list, gap: GapCollector | None = None,
                spatial: SpatialCtx | None = None) -> list:
        y = self.conv1x1(xset, gap, spatial)
        if not self.training:
            return dw_tail_fused(
                y, self.tail_packs.get(self.conv3x3_1, self.conv3x3_2),
                spatial)
        return self.conv3x3_2(self.conv3x3_1(y, gap, spatial), gap, spatial)


class CSFHead(nn.Module):
    """gOctConv fuse -> PallMSBlock (dilations 1/2/4/8/16) -> fuse1x1."""

    def __init__(self, lc: LayerConfig, *, device=None):
        super().__init__()
        fuse, ms, f1 = lc.fuse, lc.ms, lc.fuse1x1
        self.fuse = GOctCBR(fuse.in_split, fuse.out_split, 1, device=device)
        self.ms = PallMSBlock(ms.in_split, ms.dil_split, device=device)
        self.fuse1x1 = GOctCBR(f1.in_split, f1.out_split, 1, device=device)

    def forward(self, xset: list, gap: GapCollector | None = None,
                spatial: SpatialCtx | None = None) -> list:
        return self.fuse1x1(self.ms(self.fuse(xset, gap, spatial), gap,
                                    spatial), gap, spatial)


class CSNet(nn.Module):
    """CSNet from a LayerConfig, with torch-default init drawn from a
    ``torch.Generator`` seeded with ``seed`` (BN weight 1, bias 0, running
    mean 0, var 1; PReLU 0.25)."""

    def __init__(self, lc: LayerConfig, *, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.lc = lc
        plans = lc.block_plans()
        for name in STAGES:
            self.add_module(name, nn.ModuleList(
                ILBlock(lc.entries[p.entry], p, device=device)
                for p in plans if p.stage == name))
        self.oct_fuse = CSFHead(lc, device=device)
        self.cls_layer = ConvWeight(1, lc.fuse1x1.out_channels, 1, bias=True,
                                    device=device)
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, ConvWeight):
                init_conv_(m, gen)

    def forward(self, x: torch.Tensor, gap: GapCollector | None = None,
                spatial: SpatialCtx | None = None) -> torch.Tensor:
        """NHWC image batch -> NHWC saliency logits at the input size;
        a train-mode forward records the penalty's signal in ``gap``.
        Under ``spatial``, ``x`` and the result are this rank's row bands
        of images of height ``spatial.image_h``."""
        if gap is not None and not self.training:
            raise ValueError("the penalty's signal is collected by a "
                             "train-mode forward only")
        sp = spatial
        feat = [x.permute(0, 3, 1, 2).contiguous()]
        hw = x.shape[1:3]
        if sp is not None:
            hw = (sp.image_h, x.shape[2])
            tag(feat[0], sp.image_h)
        ends = {}
        for name in STAGES:
            for block in getattr(self, name):
                feat = block(feat, gap, sp)
            ends[name] = feat
        y = self.oct_fuse([ends["stage2"][0], ends["stage3"][0],
                           ends["stage4"][0]], gap, sp)
        logits = conv2d(y[0], self.cls_layer.weight, self.cls_layer.bias,
                        spatial=sp)
        return resize_bilinear(logits, hw, sp).permute(0, 2, 3, 1)


def count_params(model: nn.Module) -> int:
    """Parameter count without BN running statistics, as the reference's
    ``sum(p.nelement() for p in model.parameters())``."""
    return sum(p.numel() for p in model.parameters())


def calibrate_bn(model: nn.Module, x: torch.Tensor) -> None:
    """Set every BN's running statistics to the batch statistics of one
    train-mode forward on ``x`` (momentum None: a cumulative average over
    that one batch), then switch the model to eval. Fresh x100 nets explode
    or die in eval mode with the init statistics (mean 0, var 1); this gives
    them the statistics of real activations."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    momenta = [bn.momentum for bn in bns]
    for bn in bns:
        bn.momentum = None
        bn.reset_running_stats()
    model.train()
    with torch.no_grad():
        model(x)
    for bn, momentum in zip(bns, momenta):
        bn.momentum = momentum
    model.eval()
