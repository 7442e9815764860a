"""Image decode/encode and cv2's bilinear resize, without cv2 or PIL.

The JAX package reads and resizes through cv2 (``data/pipeline.py:57-119``,
``data/resident.py``) and sizes JPEG headers through PIL. The machine with
the card has neither, so the port carries:

- ``read_png`` / ``decode_png`` (bytes): PNG on stdlib ``zlib`` + numpy.
  Bit depths 1/2/4/8/16; gray, gray+alpha, RGB, RGBA and palette; all five
  row filters (None, Sub and Up run vectorized; Average and Paeth depend on
  the byte to their left and run byte by byte, slow but exact).
  Adam7-interlaced files are refused.
- ``write_png`` / ``encode_png``: 8-bit gray or RGB, rows filtered None or
  Up.
- ``image_size``: (h, w) from the PNG or JPEG header alone.
- ``read_image`` / ``decode_image`` (bytes): PNG through ``decode_png``;
  anything else (JPEG) through PIL when it imports, else an error naming
  the file.
- ``resize_u8_linear``: cv2's ``INTER_LINEAR`` on uint8, bit for bit: 11-bit
  fixed-point weights, and the vertical pass of cv2's SIMD kernel
  ``((b0*(s0>>4))>>16 + (b1*(s1>>4))>>16 + 2) >> 2``, with the row weights
  cv2 leaves unclamped at the top and bottom edges.
- ``resize_f32_linear``: cv2's float ``INTER_LINEAR`` (half-pixel centres,
  edge clamp, no antialiasing), within 2 f32 ulp of cv2.

Both resizes take cv2's shortcut for an exact 2x downscale on both axes
(INTER_AREA: the mean of each 2x2 block).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples
_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


# ---------------------------------------------------------------------------
# PNG


def _chunks(data: bytes, path: str):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"truncated PNG (no IEND chunk): {path}")


def _unfilter_slow(kind: int, cur: np.ndarray, prev: np.ndarray,
                   bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4): each byte needs the reconstructed byte
    ``bpp`` to its left, so the row is walked byte by byte."""
    out = bytearray(cur.tobytes())
    up = prev.tobytes()
    n = len(out)
    if kind == 3:
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
    else:
        for i in range(n):
            if i >= bpp:
                a, c = out[i - bpp], up[i - bpp]
            else:
                a = c = 0
            b = up[i]
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(rows: np.ndarray, bpp: int, path: str) -> np.ndarray:
    """Undo the per-row filters of (h, 1 + stride) raw scanlines."""
    kinds = rows[:, 0]
    data = rows[:, 1:].copy()
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} is not one of "
                         f"0-4: {path}")
    h, stride = data.shape
    prev = np.zeros(stride, np.uint8)
    r = 0
    while r < h:
        kind = int(kinds[r])
        if kind == 2:
            # a run of Up rows: each adds the row above, so the run is a
            # wrapping cumulative sum down the rows, started from prev
            end = r
            while end < h and kinds[end] == 2:
                end += 1
            block = np.cumsum(data[r:end], axis=0, dtype=np.uint8)
            data[r:end] = block + prev
            r = end
        else:
            if kind == 1:  # each byte adds the one bpp to its left
                data[r] = np.cumsum(data[r].reshape(-1, bpp), axis=0,
                                    dtype=np.uint8).reshape(-1)
            elif kind in (3, 4):
                data[r] = _unfilter_slow(kind, data[r], prev, bpp)
            r += 1
        prev = data[r - 1]
    return data


def _unpack_bits(data: np.ndarray, depth: int, samples: int) -> np.ndarray:
    """(h, stride) packed sub-byte samples -> (h, samples) uint8 values."""
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (data[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(data.shape[0], -1)[:, :samples]


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file (``decode_png``)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """Decode PNG bytes: (h, w) for gray and palette-less one-sample images,
    else (h, w, c) in the file's channel order (gray+alpha, RGB, RGBA;
    palette images come back RGB). uint8, or uint16 for 16-bit files.
    Gray samples of 1, 2 or 4 bits are scaled to 0..255, as libpng's
    expand does for cv2. ``path`` names the source in errors."""
    ihdr, plte, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"PNG without IHDR: {path}")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ValueError(f"Adam7-interlaced PNG is not supported: {path}")
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not supported: {path}")
    c = _CHANNELS[ctype]
    stride = (w * c * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"truncated PNG image data: {path}")
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    data = _unfilter(rows, max(1, c * depth // 8), path)
    if depth == 16:
        img = data.view(">u2").astype(np.uint16).reshape(h, w, c)
    elif depth == 8:
        img = data.reshape(h, w, c)
    else:
        img = _unpack_bits(data, depth, w * c).reshape(h, w, c)
        if ctype == 0:
            img = img * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        if plte is None:
            raise ValueError(f"palette PNG without PLTE: {path}")
        img = plte[img[..., 0]]
    img = np.ascontiguousarray(img)
    return img[..., 0] if img.shape[2] == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, *, filter_type: int = 2,
              level: int = 6) -> None:
    """Write ``encode_png``'s bytes to ``path``."""
    data = encode_png(img, filter_type=filter_type, level=level, path=path)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(img: np.ndarray, *, filter_type: int = 2, level: int = 6,
               path: str = "<bytes>") -> bytes:
    """Encode 8-bit gray (h, w) or RGB (h, w, 3) as PNG, every row filtered
    None (0) or Up (2), deflated at zlib ``level``."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png takes uint8 (h, w) or (h, w, 3), got "
                         f"{img.dtype} {img.shape}: {path}")
    if filter_type not in (0, 2):
        raise ValueError(f"filter_type must be 0 (None) or 2 (Up): {path}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    if filter_type == 2:
        rows = rows.copy()
        rows[1:] -= img.reshape(h, -1)[:-1]  # uint8: wraps mod 256
    body = np.empty((h, rows.shape[1] + 1), np.uint8)
    body[:, 0] = filter_type
    body[:, 1:] = rows
    ctype = 0 if img.ndim == 2 else 2
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(body.tobytes(), level))
            + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# headers, dispatch


def _jpeg_size(f, path: str) -> tuple[int, int]:
    f.seek(2)
    while True:
        b = f.read(1)
        while b and b != b"\xff":
            b = f.read(1)
        while b == b"\xff":
            b = f.read(1)
        if not b:
            raise ValueError(f"no JPEG frame header: {path}")
        marker = b[0]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue  # markers without a length
        length = struct.unpack(">H", f.read(2))[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            _, h, w = struct.unpack(">BHH", f.read(5))
            return h, w
        f.seek(length - 2, 1)


def image_size(path: str) -> tuple[int, int]:
    """(h, w) of a PNG or JPEG from its header, without decoding pixels;
    other formats go through PIL when it imports."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:8] == PNG_SIGNATURE:
            w, h = struct.unpack(">II", head[16:24])
            return h, w
        if head[:2] == b"\xff\xd8":
            return _jpeg_size(f, path)
    return _pil_image(path).size[::-1]


def _pil_image(src, name: str | None = None):
    """PIL's image of ``src`` (a path or a file object)."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{name or src}: only PNG is read without PIL; install pillow for "
            f"JPEG and other formats") from None
    return Image.open(src)


def _pil_array(im) -> np.ndarray:
    if im.mode not in ("L", "RGB", "RGBA", "I;16"):
        im = im.convert("RGB")
    return np.asarray(im)


def read_image(path: str) -> np.ndarray:
    """Decode an image file: PNG without any library (``read_png``), other
    formats (JPEG) through PIL. (h, w) or (h, w, c), RGB channel order."""
    with open(path, "rb") as f:
        if f.read(8) == PNG_SIGNATURE:
            return read_png(path)
    return _pil_array(_pil_image(path))


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """``read_image`` on encoded bytes; ``name`` names them in errors."""
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data, name)
    import io

    return _pil_array(_pil_image(io.BytesIO(data), name))


# ---------------------------------------------------------------------------
# cv2's INTER_LINEAR


def _linear_taps(src: int, dst: int, clamp: bool):
    """Source index and (1 - f, f) weights per output index, as cv2 computes
    them: half-pixel centres in double; columns (``clamp``) outside the
    source take the edge pixel at weight 1, rows keep their weights and read
    the clamped edge row twice."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst) + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    f = f - s
    if clamp:
        lo, hi = s < 0, s >= src - 1
        f[lo | hi] = 0.0
        s[lo] = 0
        s[hi] = src - 1
    return s, (1.0 - f).astype(np.float32), f.astype(np.float32)


def _area2x(img: np.ndarray) -> np.ndarray:
    x = img.astype(np.int32 if img.dtype == np.uint8 else np.float32)
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    if img.dtype == np.uint8:
        return ((s + 2) >> 2).astype(np.uint8)
    return s * np.float32(0.25)


def _shortcut(img: np.ndarray, oh: int, ow: int):
    """A copy at the same size; cv2's INTER_AREA at an exact 2x downscale;
    else None."""
    h, w = img.shape[:2]
    if (h, w) == (oh, ow):
        return img.copy()
    if (h, w) == (2 * oh, 2 * ow):
        return _area2x(img)
    return None


def resize_u8_linear(img: np.ndarray, hw) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR) for uint8
    (h, w) or (h, w, c), bit for bit."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_u8_linear takes uint8, got {img.dtype}")
    oh, ow = int(hw[0]), int(hw[1])
    out = _shortcut(img, oh, ow)
    if out is not None:
        return out
    x = img if img.ndim == 3 else img[..., None]
    h, w = x.shape[:2]
    sx, a0, a1 = _linear_taps(w, ow, clamp=True)
    a0 = np.rint(a0 * _COEF_SCALE).astype(np.int32)[None, :, None]
    a1 = np.rint(a1 * _COEF_SCALE).astype(np.int32)[None, :, None]
    xi = x.astype(np.int32)
    rows = xi[:, sx] * a0 + xi[:, np.minimum(sx + 1, w - 1)] * a1
    sy, b0, b1 = _linear_taps(h, oh, clamp=False)
    b0 = np.rint(b0 * _COEF_SCALE).astype(np.int32)[:, None, None]
    b1 = np.rint(b1 * _COEF_SCALE).astype(np.int32)[:, None, None]
    s0 = rows[np.clip(sy, 0, h - 1)] >> 4
    s1 = rows[np.clip(sy + 1, 0, h - 1)] >> 4
    v = np.clip(((b0 * s0) >> 16) + ((b1 * s1) >> 16), -32768, 32767)
    out = np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)
    return out[..., 0] if img.ndim == 2 else out


def resize_f32_linear(img: np.ndarray, hw) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR) for float32
    (h, w) or (h, w, c), within 2 f32 ulp of cv2."""
    img = np.asarray(img, np.float32)
    oh, ow = int(hw[0]), int(hw[1])
    out = _shortcut(img, oh, ow)
    if out is not None:
        return out
    x = img if img.ndim == 3 else img[..., None]
    h, w = x.shape[:2]
    sx, a0, a1 = _linear_taps(w, ow, clamp=True)
    rows = (x[:, sx] * a0[None, :, None]
            + x[:, np.minimum(sx + 1, w - 1)] * a1[None, :, None])
    sy, b0, b1 = _linear_taps(h, oh, clamp=False)
    out = (rows[np.clip(sy, 0, h - 1)] * b0[:, None, None]
           + rows[np.clip(sy + 1, 0, h - 1)] * b1[:, None, None])
    return out[..., 0] if img.ndim == 2 else out
