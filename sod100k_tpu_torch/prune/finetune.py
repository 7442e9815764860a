"""Channel pruning on the port's state_dict: BN-gamma thresholding -> slim
layer_config -> channel gathers.

A carried-over copy of ``sod100k_tpu/prune/finetune.py`` (pure numpy over the
JAX parameter pytree), rewritten for this port's state_dict: OIHW weights
and the reference's names (``stage1.0.conv1x1.bns.0.weight``). The port's
tests hold it against the JAX package's on the same weights.

- ``derive_pruned_config`` mirrors finetune_model (csnet.py:821-879): walk
  the 21 prunable layers (each ILBlock's leading CBR, then the CSF head's
  fuse / PallMS / fuse1x1), concatenate their per-branch BN gammas, zero
  channels with |gamma| < thres, and emit the new per-branch splits,
  including the MSBlock per-dilation remap (get_CSFHead_dliconf,
  :526-538) and the CSF fuse input re-stitch from the three stage-end
  widths (:857-865).
- ``gather_pruned_params`` mirrors build_model_with_weight and the
  per-module copiers (:571-818) as channel gathers: surviving output
  channels index the old tensors; input channels follow the previous
  layer's mask (the CSF fuse input mask is the concat of the three
  stage-end masks, :789-803). An ILBlock's depthwise conv3x3_1/conv3x3_2
  and their norms are sliced by the same mask as its leading CBR's outputs.
- Pruning RESETS the BN running statistics to mean 0, var 1 (and the batch
  count to 0): the reference copies only weight and bias (load_BN_weight,
  :633-651) and finetuning re-estimates them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..arch.csnet import CSNet
from ..arch.layer_config import Entry, LayerConfig

Mask = list[np.ndarray]  # per-branch 0/1 arrays
StateDict = dict[str, torch.Tensor]


def _layer_paths(lc: LayerConfig) -> list[str]:
    """Prunable-layer paths in the reference's module order."""
    paths = [f"{p.stage}.{p.index}.conv1x1" for p in lc.block_plans()]
    paths += ["oct_fuse.fuse", "oct_fuse.ms", "oct_fuse.fuse1x1"]
    return paths


def _collect_gammas(sd: StateDict, path: str, entry: Entry) -> np.ndarray:
    """Concatenated BN gammas across branches, in branch order
    (csnet.py:836-841)."""
    norm = "convs.{}.bn" if path.endswith(".ms") else "bns.{}"
    parts = []
    for j in range(len(entry.out_split)):
        key = f"{path}.{norm.format(j)}.weight"
        if key in sd:
            parts.append(sd[key].detach().cpu().numpy())
    return np.concatenate(parts)


def layer_gammas(sd: StateDict, lc: LayerConfig) -> list[np.ndarray]:
    """Each prunable layer's BN gammas, concatenated across its branches,
    in the reference's layer order: what the threshold is applied to."""
    return [_collect_gammas(sd, path, lc.entries[layer])
            for layer, path in enumerate(_layer_paths(lc))]


def derive_pruned_config(sd: StateDict, lc: LayerConfig, thres: float
                         ) -> tuple[LayerConfig, list[Mask]]:
    """New slim LayerConfig + per-layer masks (split per branch)."""
    paths = _layer_paths(lc)
    n = len(lc.entries)
    new_entries: list[Entry | None] = [None] * n
    masks: list[Mask] = [None] * n  # type: ignore[list-item]
    stages = lc.stages

    for layer, (path, gammas) in enumerate(zip(paths, layer_gammas(sd, lc))):
        entry = lc.entries[layer]
        mask_flat = (np.abs(gammas) >= thres).astype(np.int64)
        split_pts = np.cumsum(entry.out_split)[:-1]
        mask = np.split(mask_flat, split_pts)
        new_out = tuple(int(m.sum()) for m in mask)
        masks[layer] = mask
        if sum(new_out) == 0:
            # a block with no surviving channels is unrepresentable (the
            # reference builds torch convs from the counts): fail loudly
            raise ValueError(
                f"pruning at thres={thres:g} leaves layer {layer} ({path}) "
                f"with ZERO surviving channels (max |gamma| = "
                f"{float(np.abs(gammas).max()):.3g}); lower FINETUNE.THRES "
                f"or keep at least one channel per block alive.")

        if layer == 0:
            new_in: tuple[int, ...] = (3,)
        elif layer == n - 3:  # CSF fuse: stage-end widths (csnet.py:857-865)
            side4 = sum(new_entries[layer - 1].out_split)
            side3 = sum(new_entries[layer - stages[3] - 1].out_split)
            side2 = sum(new_entries[layer - stages[3] - stages[2] - 1].out_split)
            new_in = (side2, side3, side4)
        else:
            new_in = new_entries[layer - 1].out_split

        dil = None
        if entry.dil_split is not None:  # PallMS remap (get_CSFHead_dliconf)
            dil = []
            for j, branch_dil in enumerate(entry.dil_split):
                offs = 0
                row = []
                for width in branch_dil:
                    row.append(int(mask[j][offs:offs + width].sum()))
                    offs += width
                dil.append(tuple(row))
            dil = tuple(dil)
        new_entries[layer] = Entry(new_in, new_out, dil)

    return LayerConfig(tuple(new_entries), stages), masks


def _idx(mask_parts) -> np.ndarray:
    return np.nonzero(np.concatenate(mask_parts))[0]


def _take(t: torch.Tensor, keep: np.ndarray, dim: int = 0) -> torch.Tensor:
    return t.detach().index_select(dim, torch.as_tensor(keep, device=t.device))


def _gather_norm_act(sd: StateDict, out: StateDict, bn: str, act: str,
                     keep: np.ndarray) -> None:
    """Surviving channels of one BN (weight and bias; fresh running
    statistics) and its PReLU."""
    for k in ("weight", "bias"):
        out[f"{bn}.{k}"] = _take(sd[f"{bn}.{k}"], keep)
    like = sd[f"{bn}.running_mean"]
    out[f"{bn}.running_mean"] = like.new_zeros(len(keep))
    out[f"{bn}.running_var"] = like.new_ones(len(keep))
    out[f"{bn}.num_batches_tracked"] = torch.zeros(
        (), dtype=torch.long, device=like.device)
    out[f"{act}.weight"] = _take(sd[f"{act}.weight"], keep)


def _gather_cbr(sd: StateDict, out: StateDict, path: str,
                in_keep: np.ndarray, mask: Mask) -> None:
    w = sd[f"{path}.conv.weight"]
    out[f"{path}.conv.weight"] = _take(_take(w, _idx(mask), 0), in_keep, 1)
    if f"{path}.conv.bias" in sd:
        out[f"{path}.conv.bias"] = _take(sd[f"{path}.conv.bias"], _idx(mask))
    for j, m in enumerate(mask):
        if f"{path}.bns.{j}.weight" not in sd or int(m.sum()) == 0:
            continue
        _gather_norm_act(sd, out, f"{path}.bns.{j}", f"{path}.prelus.{j}",
                         np.nonzero(m)[0])


def _gather_dw(sd: StateDict, out: StateDict, path: str, mask: Mask) -> None:
    """SimplifiedGOctConvBR: depthwise per-branch weights (C, 1, 3, 3)."""
    for j, m in enumerate(mask):
        if f"{path}.convs.{j}.weight" not in sd or int(m.sum()) == 0:
            continue
        keep = np.nonzero(m)[0]
        out[f"{path}.convs.{j}.weight"] = _take(sd[f"{path}.convs.{j}.weight"],
                                                keep)
        _gather_norm_act(sd, out, f"{path}.bns.{j}", f"{path}.prelus.{j}",
                         keep)


def _gather_ms(sd: StateDict, out: StateDict, path: str, entry: Entry,
               in_mask: Mask, mask: Mask) -> None:
    """PallMSBlock: per-branch MSBlock (dilated convs + whole-branch
    BN/PReLU)."""
    for j, branch_dil in enumerate(entry.dil_split):
        ms = f"{path}.convs.{j}"
        if f"{ms}.bn.weight" not in sd or int(mask[j].sum()) == 0:
            continue
        in_keep = np.nonzero(in_mask[j])[0]
        _gather_norm_act(sd, out, f"{ms}.bn", f"{ms}.prelu",
                         np.nonzero(mask[j])[0])
        offs = 0
        for d, width in enumerate(branch_dil):
            dmask = mask[j][offs:offs + width]
            offs += width
            key = f"{ms}.msconv.{d}.weight"
            if key not in sd or int(dmask.sum()) == 0:
                continue
            out[key] = _take(_take(sd[key], np.nonzero(dmask)[0], 0),
                             in_keep, 1)


def gather_pruned_params(sd: StateDict, lc: LayerConfig,
                        masks: list[Mask]) -> StateDict:
    """The slim state_dict, gathered from the surviving channels."""
    stages = lc.stages
    out: StateDict = {}
    for i, plan in enumerate(lc.block_plans()):
        block = f"{plan.stage}.{plan.index}"
        in_keep = np.arange(3) if i == 0 else _idx(masks[i - 1])
        _gather_cbr(sd, out, f"{block}.conv1x1", in_keep, masks[i])
        _gather_dw(sd, out, f"{block}.conv3x3_1", masks[i])
        _gather_dw(sd, out, f"{block}.conv3x3_2", masks[i])

    nb = lc.num_blocks
    fuse_in = [masks[nb - stages[3] - stages[2] - 1][0],
               masks[nb - stages[3] - 1][0],
               masks[nb - 1][0]]
    _gather_cbr(sd, out, "oct_fuse.fuse", _idx(fuse_in), masks[nb])
    _gather_ms(sd, out, "oct_fuse.ms", lc.ms, masks[nb], masks[nb + 1])
    _gather_cbr(sd, out, "oct_fuse.fuse1x1", _idx(masks[nb + 1]),
                masks[nb + 2])
    out["cls_layer.weight"] = _take(sd["cls_layer.weight"],
                                    _idx(masks[nb + 2]), 1)
    out["cls_layer.bias"] = sd["cls_layer.bias"].detach().clone()
    return out


def prune(sd: StateDict, lc: LayerConfig, thres: float
          ) -> tuple[StateDict, LayerConfig, list[Mask]]:
    """One-call prune: returns (slim state_dict, slim layer_config, masks)."""
    new_lc, masks = derive_pruned_config(sd, lc, thres)
    return gather_pruned_params(sd, lc, masks), new_lc, masks


def build_pruned_csnet(lc: LayerConfig, sd: StateDict, *,
                       device: str | torch.device = "cuda") -> CSNet:
    """The slim CSNet of ``lc`` on ``device`` (the card by default), with
    the gathered state loaded strictly."""
    model = CSNet(lc, device=device)
    model.load_state_dict(sd, strict=True)
    return model
