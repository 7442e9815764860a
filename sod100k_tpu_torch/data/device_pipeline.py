"""Device-side image front-end: augment, resize, normalize on the card.

Port of ``sod100k_tpu/data/device_pipeline.py``. The host ships uint8
pixels (padded to a bucket shape); each batch then goes through

    random crop (<= max_crop px per edge) -> lr/ud flip -> bilinear resize
    to the train size -> [0, 1] scaling -> ImageNet normalization

as a few batched tensor ops: the crop and resize compose into one bilinear
gather per axis on per-image source coordinates (``torch.gather``, no loop
over images); output pixel o samples r1 + (o + 0.5) * crop / out - 0.5,
clamped to the crop box. Flips are output-side reversals.

The draws come from an explicit ``torch.Generator``
(``draw_augment_params``); the JAX package draws from ``jax.random`` keys,
so parity is held on the draws: ``preprocess_train_batch`` takes them
explicitly. Distributions match ``pipeline.Augment``: r1 ~ U[0, max_crop),
r2 ~ U[0, max_crop) + 1 from the end, flip at p=0.5, then lr/ud 50/50.
"""

from __future__ import annotations

import torch

from .pipeline import normalize01


def _axis_coords(out_len: int, start: torch.Tensor,
                 size: torch.Tensor) -> torch.Tensor:
    """(N, out_len) source coordinates for crop[start:start+size] ->
    out_len, half-pixel, clamped to the crop box (the JAX op order)."""
    o = torch.arange(out_len, dtype=torch.float32, device=start.device)
    start = start[:, None]
    size = size[:, None]
    src = start + (o + 0.5) * (size.float() / out_len) - 0.5
    return torch.minimum(torch.maximum(src, start.float()),
                         (start + size - 1).float())


def _gather_bilinear(a: torch.Tensor, coords: torch.Tensor,
                     axis: int) -> torch.Tensor:
    """Bilinear gather of (N, H, W, C) ``a`` at per-image float ``coords``
    (N, L) along ``axis`` (1: rows, 2: columns)."""
    n_src = a.shape[axis]
    lo = torch.floor(coords).long()
    hi = (lo + 1).clamp(0, n_src - 1)
    lo = lo.clamp(0, n_src - 1)
    frac = coords - lo.float()
    shape = [a.shape[0], 1, 1, 1]
    shape[axis] = coords.shape[1]
    size = list(a.shape)
    size[axis] = coords.shape[1]

    def take(idx):
        return torch.gather(a, axis, idx.reshape(shape).expand(size))

    f = frac.reshape(shape)
    return take(lo) * (1.0 - f) + take(hi) * f


def crop_resize_bilinear(img: torch.Tensor, box, out_hw) -> torch.Tensor:
    """Bilinear-resize the crop boxes (r1, ch, c1, cw), each (N,) int, of
    (N, H, W, C) images to out_hw, in f32."""
    r1, ch, c1, cw = box
    ys = _axis_coords(out_hw[0], r1, ch)
    xs = _axis_coords(out_hw[1], c1, cw)
    out = _gather_bilinear(img.float(), ys, 1)
    return _gather_bilinear(out, xs, 2)


def resize_to_native_canvas(img: torch.Tensor, hw: torch.Tensor,
                            canvas_hw) -> torch.Tensor:
    """Bilinear-resize whole (N, H, W[, C]) images to per-image sizes
    ``hw`` (N, 2), each in the top-left of a (canvas_h, canvas_w) array
    (pixels beyond hw are meaningless: mask them). Half-pixel sampling with
    edge clamp, cv2.INTER_LINEAR on the valid region; scales predictions
    back to native GT resolution."""
    squeeze = img.ndim == 3
    if squeeze:
        img = img[..., None]
    h_in, w_in = img.shape[1], img.shape[2]
    h = hw[:, :1].float()
    w = hw[:, 1:].float()
    oy = torch.arange(canvas_hw[0], dtype=torch.float32, device=img.device)
    ox = torch.arange(canvas_hw[1], dtype=torch.float32, device=img.device)
    ys = ((oy + 0.5) * (h_in / h) - 0.5).clamp(0.0, h_in - 1)
    xs = ((ox + 0.5) * (w_in / w) - 0.5).clamp(0.0, w_in - 1)
    out = _gather_bilinear(img.float(), ys, 1)
    out = _gather_bilinear(out, xs, 2)
    return out[..., 0] if squeeze else out


def draw_augment_params(generator: torch.Generator, n: int,
                        max_crop: int = 15, p_flip: float = 0.5) -> dict:
    """Per-image crop margins and flips, each (n,), on the generator's
    device: r1, c1 from the top/left; r2, c2 from the bottom/right (>= 1);
    do_flip, then flip_lr (else ud)."""
    dev = generator.device

    def margin(lo):
        return torch.randint(0, max_crop, (n,), generator=generator,
                             device=dev) + lo

    r1, r2, c1, c2 = margin(0), margin(1), margin(0), margin(1)
    do_flip = torch.rand(n, generator=generator, device=dev) < p_flip
    flip_lr = torch.rand(n, generator=generator, device=dev) < 0.5
    return {"r1": r1, "r2": r2, "c1": c1, "c2": c2,
            "do_flip": do_flip, "flip_lr": flip_lr}


def preprocess_train_batch(images_u8: torch.Tensor, gts_u8: torch.Tensor,
                           valid_hw: torch.Tensor, *,
                           generator: torch.Generator | None = None,
                           draws: dict | None = None, out_hw=(224, 224),
                           augment: bool = True,
                           max_crop: int = 15) -> dict:
    """(N, H, W, 3) uint8 images, (N, H, W) uint8 GTs (bucket-padded) and
    their (N, 2) true sizes -> {"image": f32 NHWC normalized, "target": f32
    (N, h, w, 1) in [0, 1]}. With ``augment``, ``draws``
    (``draw_augment_params``' dict) or a ``generator`` to draw them."""
    n = images_u8.shape[0]
    dev = images_u8.device
    valid_hw = valid_hw.to(dev)
    h, w = valid_hw[:, 0], valid_hw[:, 1]
    if augment:
        if draws is None:
            if generator is None:
                raise ValueError("augment needs draws or a generator")
            draws = draw_augment_params(generator, n, max_crop)
        d = {k: v.to(dev) for k, v in draws.items()}
        box = (d["r1"], h - d["r1"] - d["r2"], d["c1"], w - d["c1"] - d["c2"])
    else:
        zero = torch.zeros_like(h)
        box = (zero, h, zero, w)
    # image and GT share the coordinates: one gather over 4 channels
    both = torch.cat([images_u8, gts_u8[..., None]], dim=-1)
    out = crop_resize_bilinear(both, box, out_hw) / 255.0
    if augment:
        flipped = torch.where(d["flip_lr"][:, None, None, None],
                              out.flip(2), out.flip(1))
        out = torch.where(d["do_flip"][:, None, None, None], flipped, out)
    return {"image": normalize01(out[..., :3]), "target": out[..., 3:]}


def preprocess_infer_batch(images_u8: torch.Tensor, valid_hw: torch.Tensor,
                           *, out_hw=(224, 224)) -> torch.Tensor:
    """test.py:71-86 fixed-size protocol on device: bilinear-resize each
    image's valid region to out_hw, scale to [0, 1], ImageNet-normalize.
    Returns f32 NHWC."""
    valid_hw = valid_hw.to(images_u8.device)
    zero = torch.zeros_like(valid_hw[:, 0])
    im = crop_resize_bilinear(images_u8, (zero, valid_hw[:, 0], zero,
                                          valid_hw[:, 1]), out_hw) / 255.0
    return normalize01(im)
