"""Device-resident datasets: upload once, then train, validate and score
without moving pixels across the host link.

Port of ``sod100k_tpu/data/resident.py:37-372``:

1. ``build_resident_dataset``: decode on the host (once), resize uint8 to
   a store size (cv2's INTER_LINEAR, bit for bit), upload in one copy.
2. ``make_resident_epoch_fn``: per epoch, a permutation from an explicit
   ``torch.Generator``; per batch, a gather from the resident store, the
   crop/flip/resize/normalize augmentation (``device_pipeline``) and the
   port's train step. A Python loop over batches that never waits for the
   card: losses and penalties come back as device tensors.
   ``make_resident_csf_epoch_fn`` is the CSF dialect: per-sample
   horizontal flips only, no crop.
3. ``build_resident_val_dataset``: model inputs at the test size (uint8)
   plus native-resolution GTs on one canvas (and, optionally, the
   weighted-F tables), for per-epoch validation and the TESTALL sweep.
4. ``make_resident_val_fn`` and ``make_resident_salmetric_fn`` share one
   scoring stage (``_batch_native_maps``): forward -> per-image bilinear
   resize back to native size -> trunc(sigmoid * 255), the PNG
   quantization. The sweep returns per-batch metric sums (leading nb axis)
   that ``metrics.salmetric.result_from_sums`` reduces on the host in f64.

Every builder puts its tensors on the card unless the caller names another
device, and raises when the card is absent.

Under a mesh (``mesh``, a ``parallel.mesh.Mesh2D`` of D x S processes;
one process per card) every rank holds the whole store, as the JAX package
replicates it. The epochs draw the permutation and the augmentations of the
global batch from the same generator on every rank and keep the rank's
data index's rows; under a spatial axis each rank augments and resizes the
whole images and then keeps its band of their rows
(``Mesh2D.cut_bands``), so D*S ranks see exactly the rows, crops and flips
of one process. The evaluation paths split the batches over the D data
indices: the S ranks of a spatial group take the same batches and run them
through ``make_eval_step(mesh=...)``, which returns whole maps on each of
them, and the metric sums, which are additive, are SUM-all-reduced over the
data group (``Mesh2D.data_group``), so each data index counts once. The
JAX package's augmentation note holds here too: images are pre-resized to
the store size, so the crop acts at that scale (``max_crop`` 17 ~ 15 *
256/224).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..parallel.mesh import Mesh2D, all_reduce_sum
from .device_pipeline import preprocess_train_batch, resize_to_native_canvas
from .image_io import resize_u8_linear
from .pipeline import require_device

HOST_THREADS = 8  # decode, resize and distance-transform threads


def _rows(batch_size: int, mesh: Mesh2D | None) -> slice:
    """This rank's rows of each global batch under ``mesh`` (all of them
    without one)."""
    return slice(None) if mesh is None else mesh.rows(batch_size)


def _data_group(mesh: Mesh2D | None):
    return mesh.data_group if mesh is not None else None


def build_resident_dataset(dataset, store_hw=(256, 256), *,
                           device="cuda") -> dict:
    """Decode and uint8-resize every sample of ``dataset`` (anything with
    ``__len__`` and ``_decode_u8(i) -> (image HWC, gt HW)``) to store_hw
    and upload: {"image_u8": (N,hs,ws,3), "gt_u8": (N,hs,ws)} uint8 on
    ``device``."""
    device = require_device(device)
    n = len(dataset)
    hs, ws = store_hw
    imgs = np.empty((n, hs, ws, 3), np.uint8)
    gts = np.empty((n, hs, ws), np.uint8)

    def one(i):
        img, gt = dataset._decode_u8(i)
        imgs[i] = resize_u8_linear(img, (hs, ws))
        gts[i] = resize_u8_linear(gt, (hs, ws))

    with ThreadPoolExecutor(HOST_THREADS) as pool:
        list(pool.map(one, range(n)))
    return {"image_u8": torch.from_numpy(imgs).to(device),
            "gt_u8": torch.from_numpy(gts).to(device)}


def make_resident_epoch_fn(step_fn, *, batch_size: int, out_hw,
                           augment: bool = True, max_crop: int = 17,
                           mesh: Mesh2D | None = None):
    """An epoch over a resident store: shuffle -> per batch (gather ->
    augment -> ``step_fn``).

    ``step_fn`` is a ``train.step.make_train_step`` step built without
    ``from_u8`` (the augmentation normalizes): ``step(batch, lr,
    penalty_on) -> {"loss", "penalty"}``.

    Returns ``epoch_fn(data, generator, lr, penalty_on) -> (losses (nb,),
    penalties (nb,))``, device tensors. The permutation, then each batch's
    draws, come from ``generator`` (on the store's device), in that order.
    With ``mesh``, ``batch_size`` is the global batch and the step sees
    this rank's rows of it and, under a spatial axis, its band of their
    rows after the resize (``step_fn`` built with ``mesh`` and ``image_h =
    out_hw[0]``).
    """
    from .device_pipeline import draw_augment_params

    rows = _rows(batch_size, mesh)

    def epoch_fn(data: dict, generator: torch.Generator, lr: float,
                 penalty_on: float):
        store, gts = data["image_u8"], data["gt_u8"]
        n, hs, ws = store.shape[:3]
        nb = n // batch_size
        perm = torch.randperm(n, generator=generator, device=store.device)
        perm = perm[:nb * batch_size].reshape(nb, batch_size)
        valid = torch.tensor([[hs, ws]], dtype=torch.int64,
                             device=store.device).expand(batch_size, 2)
        losses, pens = [], []
        for idxs in perm:
            d = (draw_augment_params(generator, batch_size, max_crop)
                 if augment else None)
            idxs = idxs[rows]
            if d is not None:
                d = {k: v[rows] for k, v in d.items()}
            batch = preprocess_train_batch(
                store[idxs], gts[idxs], valid[rows], draws=d, out_hw=out_hw,
                augment=augment, max_crop=max_crop)
            if mesh is not None:
                batch = mesh.cut_bands(batch)
            m = step_fn(batch, lr, penalty_on)
            losses.append(m["loss"])
            pens.append(m["penalty"])
        return torch.stack(losses), torch.stack(pens)

    return epoch_fn


def make_resident_csf_epoch_fn(step_fn, *, batch_size: int,
                               mesh: Mesh2D | None = None):
    """An epoch of the CSF recipe over a resident store: shuffle -> per
    batch (gather -> per-sample horizontal flip at p=0.5 -> ImageNet
    normalization of the u8 image and target / 255 on the device ->
    ``step_fn``). No crop and no resize (the reference's dataset.py).

    ``step_fn`` is a ``train.csf_step.CSFTrainStep`` built without
    ``from_u8``: ``step(batch, lr) -> {"loss"}``; the model's BN statistics
    are frozen, so nothing but its parameters moves.

    Returns ``epoch_fn(data, generator, lr, draws=None) -> losses (nb,)``,
    a device tensor. The permutation, then the (nb, batch_size) flips, come
    from ``generator`` (on the store's device), unless ``draws`` gives them:
    ``(perm (nb, batch_size) int64, flips (nb, batch_size) bool)``. With
    ``mesh``, ``batch_size`` is the global batch, the step sees this
    rank's rows of it and, under a spatial axis, its band of their rows
    (the flip acts on W, so it commutes with the cut; ``step_fn`` built
    with ``mesh`` and ``image_h`` the store's height), and the losses are
    this rank's shares.
    """
    from .pipeline import normalize_u8

    rows = _rows(batch_size, mesh)

    def epoch_fn(data: dict, generator: torch.Generator, lr: float,
                 draws=None) -> torch.Tensor:
        store, gts = data["image_u8"], data["gt_u8"]
        n = store.shape[0]
        nb = n // batch_size
        if draws is None:
            perm = torch.randperm(n, generator=generator,
                                  device=store.device)
            perm = perm[:nb * batch_size].reshape(nb, batch_size)
            flips = torch.rand((nb, batch_size), generator=generator,
                               device=store.device) < 0.5
        else:
            perm, flips = (torch.as_tensor(d, device=store.device)
                           for d in draws)
        losses = []
        for idxs, fl in zip(perm[:, rows], flips[:, rows]):
            img, gt = store[idxs], gts[idxs]
            img = torch.where(fl[:, None, None, None], img.flip(2), img)
            gt = torch.where(fl[:, None, None], gt.flip(2), gt)
            batch = {"image": normalize_u8(img),
                     "target": gt.float()[..., None] / 255.0}
            if mesh is not None:
                batch = mesh.cut_bands(batch)
            losses.append(step_fn(batch, lr)["loss"])
        return torch.stack(losses)

    return epoch_fn


def build_resident_val_dataset(dataset, in_hw, batch_size: int, *,
                               device="cuda", with_wf_tables: bool = False,
                               wf_budget_bytes: int | None = None) -> dict:
    """Upload a whole val/test split once: model inputs at ``in_hw`` (uint8,
    host resize) plus native-resolution GTs padded onto one canvas. N is
    padded to a batch_size multiple with weight-0 copies of sample 0.

    Returns {"image_u8": (N',h,w,3), "gt_u8": (N',H,W), "hw": (N',2) int32,
    "weight": (N',) float32} on ``device`` plus "_canvas_hw" (host
    metadata). ``with_wf_tables`` adds the weighted-F tables ("wf_idx"
    int32 (N',H*W), "wf_weight" f32 (N',H,W); 8 bytes per canvas pixel)
    unless they would exceed ``wf_budget_bytes``, in which case the reason
    lands under "_wf_skipped"."""
    device = require_device(device)
    n = len(dataset)
    with ThreadPoolExecutor(HOST_THREADS) as pool:
        pairs = list(pool.map(dataset._decode_u8, range(n)))
    canvas_h = max(g.shape[0] for _, g in pairs)
    canvas_w = max(g.shape[1] for _, g in pairs)
    n_pad = -(-n // batch_size) * batch_size
    hs, ws = in_hw
    imgs = np.zeros((n_pad, hs, ws, 3), np.uint8)
    gts = np.zeros((n_pad, canvas_h, canvas_w), np.uint8)
    hws = np.ones((n_pad, 2), np.int32)
    wts = np.zeros((n_pad,), np.float32)

    def one(i):
        img, gt = pairs[i] if i < n else pairs[0]
        imgs[i] = resize_u8_linear(img, (hs, ws))
        gts[i, :gt.shape[0], :gt.shape[1]] = gt
        hws[i] = gt.shape[:2]
        wts[i] = 1.0 if i < n else 0.0

    with ThreadPoolExecutor(HOST_THREADS) as pool:
        list(pool.map(one, range(n_pad)))

    def put(a):
        return torch.from_numpy(a).to(device)

    out = {"image_u8": put(imgs), "gt_u8": put(gts), "hw": put(hws),
           "weight": put(wts), "_canvas_hw": (canvas_h, canvas_w)}
    if with_wf_tables:
        wf_bytes = n_pad * canvas_h * canvas_w * 8  # int32 idx + f32 weight
        if wf_budget_bytes and wf_bytes > wf_budget_bytes:
            out["_wf_skipped"] = (
                f"wF tables need {wf_bytes / 2**20:.0f} MiB of device memory "
                f"> budget {wf_budget_bytes / 2**20:.0f} MiB")
        else:
            from ..metrics.wfmeasure import precompute_wf_tables

            # the distance transforms release the GIL: chunks on threads
            step = -(-n_pad // HOST_THREADS)
            with ThreadPoolExecutor(HOST_THREADS) as pool:
                parts = list(pool.map(
                    lambda i: precompute_wf_tables(gts[i:i + step],
                                                   hws[i:i + step]),
                    range(0, n_pad, step)))
            out["wf_idx"] = put(np.concatenate([t["wf_idx"] for t in parts]))
            out["wf_weight"] = put(np.concatenate([t["wf_weight"]
                                                   for t in parts]))
    return out


def _batch_native_maps(eval_step, img, hw, canvas_hw):
    """The shared scoring stage of both resident evaluation paths: forward
    -> per-image bilinear resize back onto the canvas -> trunc(sigmoid *
    255) (the PNG value, as float), plus the per-image validity masks."""
    ch, cw = canvas_hw
    pred = eval_step(img)[..., 0].float()
    up = resize_to_native_canvas(pred, hw, (ch, cw))
    sal255 = torch.trunc(up * 255.0)
    rows = torch.arange(ch, device=hw.device)[None, :, None]
    cols = torch.arange(cw, device=hw.device)[None, None, :]
    mask = ((rows < hw[:, :1, None]) & (cols < hw[:, 1:, None])).float()
    return sal255, mask


def _batches(data: dict, batch_size: int, keys, mesh=None):
    """(index, batch) of the split's batches that this rank scores: every
    D-th from its data index (the S ranks of a spatial group take the same
    ones), all of them without a mesh."""
    nb = data["image_u8"].shape[0] // batch_size
    d, r = (mesh.data, mesh.data_index) if mesh is not None else (1, 0)
    if d > nb:
        raise ValueError(f"{nb} batches of {batch_size} cannot be shared by "
                         f"{d} data indices; use a smaller batch")
    for b in range(r, nb, d):
        sl = slice(b * batch_size, (b + 1) * batch_size)
        yield b, {k: data[k][sl] for k in keys if k in data}


def make_resident_salmetric_fn(eval_step, *, batch_size: int, canvas_hw,
                               mesh: Mesh2D | None = None):
    """The TESTALL sweep over a resident split: per batch, forward ->
    native resize-back -> PNG quantization -> threshold counts, MAE, P/R,
    E-measure, adaptive F and E, S-measure and (when the store has the
    tables) weighted F, summed over the batch's images.

    ``eval_step``: ``make_eval_step(model, from_u8=True, ...)``. Returns
    ``fn(data) -> dict`` of per-batch sums on the card, each with a leading
    (nb,) axis: "n", "mae_sum", "p_sum"/"r_sum"/"e_sum" (256 each),
    "a_sum", "ae_sum", "s_sum" and "w_sum". Reduce them on the host with
    ``metrics.salmetric.result_from_sums``. With ``mesh`` (``eval_step``
    built with it) each data index scores its share of the batches and the
    (nb, ...) sums are all-reduced over the data group: every rank returns
    the single-process sums."""
    from ..metrics.salmetric import (adaptive_e_per_image,
                                     adaptive_f_per_image, per_image_stats)
    from ..metrics.smeasure import s_measure_batch
    from ..metrics.wfmeasure import wf_per_image_device

    keys = ("image_u8", "gt_u8", "hw", "weight", "wf_idx", "wf_weight")

    @torch.inference_mode()
    def fn(data: dict) -> dict:
        nb = data["image_u8"].shape[0] // batch_size
        out = {}
        for b, xs in _batches(data, batch_size, keys, mesh):
            wt = xs["weight"]
            sal255, mask = _batch_native_maps(eval_step, xs["image_u8"],
                                              xs["hw"], canvas_hw)
            gt = xs["gt_u8"].float()
            mae, pre, rec, em = per_image_stats(sal255, gt, mask)
            sums = {
                "n": wt.sum(),
                "mae_sum": torch.sum(mae * wt),
                "p_sum": torch.sum(pre * wt[:, None], dim=0),
                "r_sum": torch.sum(rec * wt[:, None], dim=0),
                "e_sum": torch.sum(em * wt[:, None], dim=0),
                "a_sum": torch.sum(adaptive_f_per_image(sal255, gt, mask)
                                   * wt),
                "ae_sum": torch.sum(adaptive_e_per_image(sal255, gt, mask)
                                    * wt),
                "s_sum": torch.sum(s_measure_batch(
                    sal255 / 255.0, (gt > 128).float(), mask) * wt),
            }
            if "wf_idx" in xs:
                sums["w_sum"] = torch.sum(wf_per_image_device(
                    sal255 / 255.0, xs["gt_u8"], mask, xs["wf_idx"],
                    xs["wf_weight"]) * wt)
            for k, v in sums.items():
                if k not in out:
                    out[k] = v.new_zeros((nb, *v.shape))
                out[k][b] = v
        # under a mesh each data index filled its batches' rows and left
        # zeros elsewhere: the SUM over the data group (never the world,
        # whose S ranks per data index hold the same rows) has one
        # non-zero term per row, so it is exact
        return all_reduce_sum(out, _data_group(mesh))

    return fn


def make_resident_val_fn(eval_step, *, batch_size: int, canvas_hw,
                         mesh: Mesh2D | None = None):
    """Validation over a resident val set: per image, the map resized to
    its native (h, w), trunc-quantized to /255 steps and L1-scored against
    the native GT (the host protocol, cli/common.py val_mae).

    ``eval_step``: ``make_eval_step(model, from_u8=True, ...)``. Returns
    ``val_fn(data) -> MAE``, a 0-d f32 tensor on the card (weighted by
    "weight", so the padding copies count for nothing). With ``mesh``
    (``eval_step`` built with it) each data index scores its share of the
    batches and the sums are all-reduced over the data group."""

    @torch.inference_mode()
    def val_fn(data: dict) -> torch.Tensor:
        dev = data["image_u8"].device
        s = c = torch.zeros((), device=dev)
        for _, xs in _batches(data, batch_size, ("image_u8", "gt_u8", "hw",
                                                 "weight"), mesh):
            hw, wt = xs["hw"], xs["weight"]
            sal255, mask = _batch_native_maps(eval_step, xs["image_u8"], hw,
                                              canvas_hw)
            diff = torch.abs(sal255 / 255.0
                             - xs["gt_u8"].float() / 255.0) * mask
            maes = diff.sum(dim=(1, 2)) / (hw[:, 0] * hw[:, 1]).float()
            s, c = s + torch.sum(maes * wt), c + wt.sum()
        tot = all_reduce_sum({"s": s, "c": c}, _data_group(mesh))
        return tot["s"] / tot["c"]

    return val_fn
