"""Port parity, the data path: sod100k_tpu_torch.data against the JAX
package's data modules (and cv2/PIL, which the port does without), on the
CPU.

- The PNG codec against cv2-written and cv2-read files (gray, RGB, RGBA,
  16-bit; every row filter), its header reader against PIL, and cv2's
  uint8/float INTER_LINEAR resizes (u8 bit for bit; f32 within 1e-6).
- SalData items, Augment draws and the three batch iterators equal to the
  JAX package's on a PNG tree (uint8 bit-equal, float within 1e-5).
- The device front-end within 1e-5, fed the JAX package's own draws.
- The resident TESTALL sweep and validation on the port's CSNet against the
  JAX ones on the same weights (BN calibrated, as in test_torch_csnet.py),
  at the JAX test's bars (tests/test_device_pipeline.py:347-355).
"""

import os
import struct
import sys
import threading
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sod100k_tpu.arch.layer_config import init_layers as jinit_layers
from sod100k_tpu.data import device_pipeline as jdp
from sod100k_tpu.data import pipeline as jpl
from sod100k_tpu.data import resident as jres
from sod100k_tpu.data import synth as jsynth
from sod100k_tpu.interop.torch_ckpt import state_dict_to_pytree
from sod100k_tpu.metrics import salmetric as jsal
from sod100k_tpu.train import step as jstep
from sod100k_tpu_torch.arch.csnet import CSNet, calibrate_bn
from sod100k_tpu_torch.arch.layer_config import init_layers
from sod100k_tpu_torch.data import device_pipeline as dp
from sod100k_tpu_torch.data import image_io
from sod100k_tpu_torch.data import pipeline as pl
from sod100k_tpu_torch.data import resident, synth
from sod100k_tpu_torch.metrics.salmetric import result_from_sums
from sod100k_tpu_torch.train.optim import make_adam
from sod100k_tpu_torch.train.step import make_eval_step, make_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZES = [(48, 96), (80, 80), (55, 48), (64, 72), (72, 64), (60, 70)]


@pytest.fixture(scope="module")
def png_tree(tmp_path_factory):
    """images/*.png + GT/*.png written by cv2, at SIZES."""
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(0)
    (root / "images").mkdir()
    (root / "GT").mkdir()
    yy, xx = np.mgrid[0:80, 0:96]
    for i, (h, w) in enumerate(SIZES):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        blob = ((yy - h // 2) ** 2 + (xx - w // 3) ** 2 < (h // 3) ** 2)
        gt = (blob[:h, :w] * 255).astype(np.uint8)
        img[gt > 0] //= 2
        cv2.imwrite(str(root / "images" / f"p{i}.png"), img)
        cv2.imwrite(str(root / "GT" / f"p{i}.png"), gt)
    return str(root)


# ---------------------------------------------------------------------------
# PNG codec, headers, resizes


def _rgb_of_cv2(a):
    return a[..., ::-1] if a.ndim == 3 and a.shape[2] == 3 else (
        a[..., [2, 1, 0, 3]] if a.ndim == 3 else a)


CODEC_CASES = {
    "gray": ((37, 53), np.uint8), "rgb": ((41, 29, 3), np.uint8),
    "rgba": ((23, 31, 4), np.uint8), "gray16": ((19, 27), np.uint16),
    "rgb16": ((19, 27, 3), np.uint16), "rgba16": ((9, 11, 4), np.uint16),
}


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_png_decodes_cv2_written_files(case, tmp_path):
    """cv2 (libpng) picks each row's filter adaptively; smooth images make
    it use Sub/Up/Average/Paeth, noise mostly None."""
    shape, dtype = CODEC_CASES[case]
    rng = np.random.default_rng(1)
    top = np.iinfo(dtype).max + 1
    for kind in ("noise", "smooth"):
        if kind == "noise":
            a = rng.integers(0, top, shape, dtype=dtype)
        else:
            ramp = np.add.outer(np.arange(shape[0]), 3 * np.arange(shape[1]))
            ramp = (ramp * (top // 256)) % top
            ramp = ramp.reshape(*shape[:2], *[1] * (len(shape) - 2))
            a = np.broadcast_to(ramp, shape).astype(dtype)
            if len(shape) == 3:
                a = (a + np.arange(shape[2]) * 17 * (top // 256)).astype(dtype)
        p = str(tmp_path / f"{case}_{kind}.png")
        cv2.imwrite(p, a)
        got = image_io.read_png(p)
        want = _rgb_of_cv2(cv2.imread(p, cv2.IMREAD_UNCHANGED))
        assert got.dtype == want.dtype == dtype
        np.testing.assert_array_equal(got, want)
        assert image_io.image_size(p) == shape[:2]


def _filter_row(kind, cur, prev, bpp):
    """The PNG spec's encoder side of each filter, byte by byte."""
    out = []
    for i, x in enumerate(cur):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out.append((x - pred) & 0xFF)
    return bytes([kind]) + bytes(out)


def _encode(path, a, kinds, depth=8, interlace=0):
    h, w = a.shape[:2]
    c = 1 if a.ndim == 2 else a.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[c]
    raw = a.astype(">u2").tobytes() if depth == 16 else a.tobytes()
    stride = w * c * depth // 8
    rows, prev = [], bytes(stride)
    for r in range(h):
        cur = raw[r * stride:(r + 1) * stride]
        rows.append(_filter_row(kinds[r % len(kinds)], cur, prev,
                                c * depth // 8))
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(image_io.PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                             0, 0, interlace))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4],
                                   [4, 3, 2, 1, 0, 2]])
def test_png_each_row_filter(kinds, tmp_path):
    """Files whose rows all use one filter (and a mix): decoded equal to
    the pixels and to cv2, for 1, 3 and 4 bytes a pixel and 16 bits."""
    rng = np.random.default_rng(2)
    for shape, depth in (((9, 13), 8), ((7, 10, 3), 8), ((6, 5, 4), 8),
                         ((5, 7, 3), 16)):
        a = rng.integers(0, 1 << depth, shape).astype(
            np.uint16 if depth == 16 else np.uint8)
        p = str(tmp_path / f"f{len(shape)}_{depth}.png")
        _encode(p, a, kinds, depth)
        np.testing.assert_array_equal(image_io.read_png(p), a)
        np.testing.assert_array_equal(
            _rgb_of_cv2(cv2.imread(p, cv2.IMREAD_UNCHANGED)), a)


@pytest.mark.parametrize("kind", ["1bit", "palette", "gray_alpha", "rgb",
                                  "rgba", "gray16"])
def test_readers_match_cv2(kind, tmp_path):
    """The image and GT readers against cv2.imread on files PIL and cv2
    write: 1-bit gray, palette and gray+alpha (PIL), colour and 16-bit GTs
    (outside the 8-bit gray envelope: colour luma within one level)."""
    rng = np.random.default_rng(14)
    p = str(tmp_path / f"{kind}.png")
    rgb = rng.integers(0, 256, (33, 45, 3), dtype=np.uint8)
    if kind in ("1bit", "palette", "gray_alpha"):
        Image.fromarray(rgb).convert({"1bit": "1", "palette": "P",
                                      "gray_alpha": "LA"}[kind]).save(p)
    elif kind == "gray16":
        cv2.imwrite(p, rng.integers(0, 65536, (33, 45), dtype=np.uint16))
    else:
        cv2.imwrite(p, rng.integers(0, 256, (33, 45, len(kind)),
                                    dtype=np.uint8))
    want = cv2.imread(p, cv2.IMREAD_COLOR)[..., ::-1]
    if kind != "gray16":
        np.testing.assert_array_equal(pl._imread_rgb_u8(p), want)
    gray = pl._imread_gray_u8(p).astype(np.int32)
    d = np.abs(gray - cv2.imread(p, cv2.IMREAD_GRAYSCALE))
    assert d.max() <= (1 if kind in ("rgb", "rgba") else 0)


def test_png_refuses_interlaced(tmp_path):
    p = str(tmp_path / "adam7.png")
    _encode(p, np.zeros((4, 4), np.uint8), [0], interlace=1)
    with pytest.raises(ValueError, match="Adam7.*adam7.png"):
        image_io.read_png(p)


@pytest.mark.parametrize("filter_type", [0, 2])
@pytest.mark.parametrize("shape", [(31, 45), (30, 41, 3)])
def test_png_round_trip(shape, filter_type, tmp_path):
    a = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    p = str(tmp_path / "rt.png")
    image_io.write_png(p, a, filter_type=filter_type)
    np.testing.assert_array_equal(image_io.read_png(p), a)
    np.testing.assert_array_equal(
        _rgb_of_cv2(cv2.imread(p, cv2.IMREAD_UNCHANGED)), a)


def test_image_size_matches_pil(tmp_path):
    rng = np.random.default_rng(4)
    for name, kw in (("a.png", {}), ("b.jpg", {}),
                     ("c.jpg", {"progressive": True})):
        p = str(tmp_path / name)
        Image.fromarray(rng.integers(0, 256, (33, 57, 3), dtype=np.uint8)
                        ).save(p, **kw)
        assert image_io.image_size(p) == Image.open(p).size[::-1] == (33, 57)


def test_jpeg_reads_through_pil_only(tmp_path, monkeypatch):
    p = str(tmp_path / "x.jpg")
    Image.fromarray(np.random.default_rng(5).integers(
        0, 256, (20, 30, 3), dtype=np.uint8)).save(p)
    np.testing.assert_array_equal(image_io.read_image(p),
                                  np.asarray(Image.open(p)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="x.jpg"):
        image_io.read_image(p)
    assert image_io.image_size(p) == (20, 30)  # the header needs no PIL


RESIZES = [((300, 400), (224, 224)), ((400, 300), (256, 256)),
           ((217, 333), (224, 224)), ((120, 90), (224, 224)),
           ((224, 224), (300, 400)), ((80, 80), (48, 48)),
           ((48, 96), (48, 48)), ((96, 96), (48, 48))]  # the last: 2x


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_u8_matches_cv2(src, dst):
    rng = np.random.default_rng(6)
    worst, share = 0, 0.0
    for c in (3, 1):
        img = rng.integers(0, 256, (*src, c) if c == 3 else src,
                           dtype=np.uint8)
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
        got = image_io.resize_u8_linear(img, dst)
        assert got.shape == want.shape and got.dtype == np.uint8
        d = np.abs(got.astype(np.int32) - want)
        worst, share = max(worst, int(d.max())), max(share, (d > 0).mean())
    print(f"u8 resize {src}->{dst}: max |d| {worst}, share differing "
          f"{share:.2e}")
    assert worst <= 1
    if (src, dst) == ((300, 400), (224, 224)):
        assert worst == 0


@pytest.mark.parametrize("src,dst", RESIZES + [((64, 64), (37, 45))])
def test_resize_f32_matches_cv2(src, dst):
    img = np.random.default_rng(7).random((*src, 3)).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(image_io.resize_f32_linear(img, dst), want,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        image_io.resize_f32_linear(img[..., 0], dst),
        cv2.resize(img[..., 0], dst[::-1], interpolation=cv2.INTER_LINEAR),
        rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# host pipeline


def _assert_items_equal(got: dict, want: dict, atol=0.0):
    assert got.keys() == want.keys()
    for k, v in want.items():
        g = got[k]
        if isinstance(v, list):
            assert len(g) == len(v)
            for a, b in zip(g, v):
                np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=k)
        elif np.asarray(v).dtype == np.uint8 or atol == 0.0:
            np.testing.assert_array_equal(g, v, err_msg=k)
        else:
            np.testing.assert_allclose(g, v, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("mode", ["train", "val"])
def test_sal_data_items_match_jax(png_tree, mode):
    port = pl.SalData(png_tree, (48, 48), mode=mode, seed=3)
    ref = jpl.SalData(png_tree, (48, 48), mode=mode, seed=3)
    assert port.stems == ref.stems and port.img_ext == ref.img_ext
    for ds in (port, ref):
        ds.set_epoch_seed(9)
    for i in range(len(port)):
        _assert_items_equal(port.raw_item(i), ref.raw_item(i))
        _assert_items_equal(port.hybrid_item(i), ref.hybrid_item(i))
        _assert_items_equal(port[i], ref[i], atol=1e-5)


def test_augment_draws_match_jax():
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (50, 61, 3), dtype=np.uint8)
    gt = rng.integers(0, 256, (50, 61), dtype=np.uint8)
    port, ref = pl.Augment(seed=4), jpl.Augment(seed=4)
    for key in [(e, i) for e in range(4) for i in range(12)]:
        for a, b in zip(port(img, gt, key), ref(img, gt, key)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="too small"):
        port(img[:30], gt[:30])


def test_batch_iterators_match_jax(png_tree):
    for mode, shuffle in (("train", True), ("val", False)):
        port = pl.SalData(png_tree, (48, 48), mode=mode, seed=5)
        ref = jpl.SalData(png_tree, (48, 48), mode=mode, seed=5)
        for it_p, it_r, atol in ((pl.batches, jpl.batches, 1e-5),
                                 (pl.hybrid_batches, jpl.hybrid_batches, 0.0),
                                 (pl.raw_batches, jpl.raw_batches, 0.0)):
            if mode == "val" and it_p is not pl.batches:
                continue
            got = list(it_p(port, 4, shuffle=shuffle, seed=11,
                            drop_last=False, num_threads=2))
            want = list(it_r(ref, 4, shuffle=shuffle, seed=11,
                             drop_last=False, num_threads=2))
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                _assert_items_equal(g, w, atol=atol)


def test_preprocess_test_image_matches_jax(png_tree):
    path = os.path.join(png_tree, "images", "p0.png")
    for hw in ((48, 48), (0, 0)):
        got, ghw = pl.preprocess_test_image(path, hw)
        want, whw = jpl.preprocess_test_image(path, hw)
        assert ghw == whw and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("jitter", [0, 3])
def test_synth_split_matches_jax(jitter, tmp_path):
    """The GTs are bit-equal; the images are PNG (the JAX package's are
    JPEG): equal to the arrays drawn, with the disc in the colour the JAX
    package's file has."""
    port = synth.make_synth_split(str(tmp_path / "port"), 4, hw=(60, 80),
                                  jitter=jitter)
    ref = jsynth.make_synth_split(str(tmp_path / "jax"), 4, hw=(60, 80),
                                  jitter=jitter)
    pds, rds = pl.SalData(port, (48, 48)), jpl.SalData(ref, (48, 48))
    pairs = list(synth.synth_pairs(4, hw=(60, 80), jitter=jitter))
    for i, (img, gt) in enumerate(pairs):
        pimg, pgt = pds._decode_u8(i)
        rimg, rgt = rds._decode_u8(i)
        np.testing.assert_array_equal(pgt, rgt)
        np.testing.assert_array_equal(pgt, gt)
        np.testing.assert_array_equal(pimg, img)
        blob = gt > 0
        np.testing.assert_array_equal(pimg[blob][0], (60, 70, 190))
        assert np.abs(rimg[blob].mean(0) - (60, 70, 190)).max() < 12
    # idempotent: a full directory is left as it is
    before = os.path.getmtime(os.path.join(port, "GT", "s0000.png"))
    synth.make_synth_split(port, 4, hw=(60, 80), jitter=jitter)
    assert os.path.getmtime(os.path.join(port, "GT", "s0000.png")) == before


def test_device_prefetch_cpu_in_order_and_abandoned(png_tree):
    ds = pl.SalData(png_tree, (48, 48), mode="val")
    want = list(pl.raw_batches(ds, 2, shuffle=False))
    got = list(pl.device_prefetch(iter(want), device="cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    before = threading.active_count()

    def endless():
        while True:
            yield {"x": np.zeros(4, np.float32), "tag": "t"}

    it = pl.device_prefetch(endless(), device="cpu", depth=2)
    first = next(it)
    assert first["tag"] == "t" and first["x"].shape == (4,)
    it.close()  # the consumer walks away
    assert threading.active_count() == before


def test_device_paths_default_to_the_card(png_tree):
    """No silent CPU fallback: without a card the defaults raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the defaults run there")
    ds = pl.SalData(png_tree, (48, 48), mode="val")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(pl.device_prefetch(iter([{"x": np.zeros(2)}])))
    with pytest.raises(RuntimeError, match="CUDA"):
        resident.build_resident_dataset(ds, (32, 32))
    with pytest.raises(RuntimeError, match="CUDA"):
        resident.build_resident_val_dataset(ds, (32, 32), 2)


# ---------------------------------------------------------------------------
# device front-end


def _t(a):
    return torch.from_numpy(np.array(a))


def test_crop_resize_and_native_canvas_match_jax():
    rng = np.random.default_rng(9)
    img = (rng.random((3, 57, 63, 4)) * 255).astype(np.float32)
    boxes = np.asarray([(0, 56, 0, 62), (5, 49, 7, 54), (14, 28, 14, 34)],
                       np.int32)
    want = np.stack([np.asarray(jdp.crop_resize_bilinear(
        jnp.asarray(img[i]), tuple(jnp.int32(v) for v in boxes[i]), (32, 40)))
        for i in range(3)])
    got = dp.crop_resize_bilinear(_t(img), tuple(_t(boxes[:, k])
                                                 for k in range(4)), (32, 40))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)

    pred = rng.random((4, 48, 48)).astype(np.float32)
    hw = np.asarray([(37, 45), (90, 120), (48, 48), (13, 101)], np.int32)
    got = dp.resize_to_native_canvas(_t(pred), _t(hw), (96, 128)).numpy()
    want = np.asarray(jax.vmap(lambda p, s: jdp.resize_to_native_canvas(
        p, s, (96, 128)))(jnp.asarray(pred), jnp.asarray(hw)))
    for i, (h, w) in enumerate(hw):
        np.testing.assert_allclose(got[i, :h, :w], want[i, :h, :w], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(
            got[i, :h, :w], image_io.resize_f32_linear(pred[i], (h, w)),
            rtol=0, atol=1e-5)


def _train_inputs(seed=10):
    rng = np.random.default_rng(seed)
    hw = np.asarray([(50, 61), (64, 64), (40, 45), (58, 33)], np.int32)
    img = np.zeros((4, 64, 64, 3), np.uint8)
    gt = np.zeros((4, 64, 64), np.uint8)
    for i, (h, w) in enumerate(hw):
        img[i, :h, :w] = rng.integers(1, 256, (h, w, 3), dtype=np.uint8)
        gt[i, :h, :w] = rng.integers(0, 256, (h, w), dtype=np.uint8)
    return img, gt, hw


@pytest.mark.parametrize("augment", [True, False])
def test_preprocess_train_batch_matches_jax_draws(augment):
    img, gt, hw = _train_inputs()
    key = jax.random.key(3)
    want = jdp.preprocess_train_batch(
        jnp.asarray(img), jnp.asarray(gt), jnp.asarray(hw), key,
        out_hw=(32, 40), augment=augment, max_crop=15)
    keys = jax.random.split(key, 4)
    r1, r2, c1, c2, do_flip, flip_lr = jax.vmap(
        lambda k: jdp._draw_augment_params(k, 15))(keys)
    draws = {k: _t(np.asarray(v)) for k, v in zip(
        ("r1", "r2", "c1", "c2", "do_flip", "flip_lr"),
        (r1, r2, c1, c2, do_flip, flip_lr))}
    if augment:
        assert draws["do_flip"].any() and not draws["do_flip"].all()
    got = dp.preprocess_train_batch(_t(img), _t(gt), _t(hw), draws=draws,
                                    out_hw=(32, 40), augment=augment)
    for k in ("image", "target"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5)


def test_preprocess_infer_batch_matches_jax():
    """Within 1e-5 on the [0, 1] scale: XLA reassociates the coordinate
    arithmetic (up to 7.6e-6 on a coordinate near 50 at 50 -> 48 rows),
    which the division by the ImageNet std (x1/0.225) would amplify."""
    img, _, hw = _train_inputs(11)
    want = jdp.preprocess_infer_batch(jnp.asarray(img), jnp.asarray(hw),
                                      out_hw=(48, 48))
    got = dp.preprocess_infer_batch(_t(img), _t(hw), out_hw=(48, 48))

    def unit(x):
        return np.asarray(x) * pl.IMAGENET_STD + pl.IMAGENET_MEAN

    np.testing.assert_allclose(unit(got.numpy()), unit(want), rtol=0,
                               atol=1e-5)


def test_port_draws_range_and_rates():
    """The port's own draws: bounds, and means and flip rates within 3
    sigma over 4096 draws."""
    n = 4096
    d = dp.draw_augment_params(torch.Generator().manual_seed(0), n, 15)
    for k, lo in (("r1", 0), ("c1", 0), ("r2", 1), ("c2", 1)):
        assert d[k].min().item() == lo and d[k].max().item() == lo + 14
        sigma = (15 ** 2 - 1) / 12 ** 0.5 / n ** 0.5 / 15 ** 0.5 * 15 ** 0.5
        assert abs(d[k].double().mean().item() - (lo + 7)) < 3 * sigma
    for k in ("do_flip", "flip_lr"):
        assert abs(d[k].double().mean().item() - 0.5) < 3 * (0.25 / n) ** 0.5
    with pytest.raises(ValueError, match="draws or a generator"):
        img, gt, hw = _train_inputs()
        dp.preprocess_train_batch(_t(img), _t(gt), _t(hw))


# ---------------------------------------------------------------------------
# resident paths


@pytest.fixture(scope="module")
def calibrated():
    """A CSNet (init_layers(8)) with BN statistics from one seeded batch,
    and its JAX parameters."""
    model = CSNet(init_layers(8, (0.5, 0.5)), seed=1, device="cpu")
    rng = np.random.default_rng(12)
    calibrate_bn(model, torch.from_numpy(
        rng.standard_normal((4, 48, 48, 3), dtype=np.float32)))
    return model, state_dict_to_pytree(model.state_dict())


def test_resident_stores_match_jax(png_tree):
    port = pl.SalData(png_tree, (48, 48), mode="val")
    ref = jpl.SalData(png_tree, (48, 48), mode="val")
    got = resident.build_resident_dataset(port, (64, 64), device="cpu")
    want = jres.build_resident_dataset(ref, (64, 64))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    got = resident.build_resident_val_dataset(port, (48, 48), 4,
                                              device="cpu",
                                              with_wf_tables=True)
    want = jres.build_resident_val_dataset(ref, (48, 48), 4,
                                           with_wf_tables=True)
    assert got.pop("_canvas_hw") == want.pop("_canvas_hw") == (80, 96)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    small = resident.build_resident_val_dataset(
        port, (48, 48), 4, device="cpu", with_wf_tables=True,
        wf_budget_bytes=16)
    assert "wf_idx" not in small and "MiB" in small["_wf_skipped"]


@pytest.fixture(scope="module")
def val_tree(tmp_path_factory):
    """A val split of 12 PNG pairs from 48x96 to 80x80 with large discs:
    a quantization level that flips between the two frameworks' forwards
    (a few pixels in 10^4) then moves a recall point by ~1e-4, not more."""
    root = tmp_path_factory.mktemp("val")
    rng = np.random.default_rng(13)
    (root / "images").mkdir()
    (root / "GT").mkdir()
    for i in range(12):
        h, w = SIZES[i % len(SIZES)]
        yy, xx = np.mgrid[0:h, 0:w]
        cy, cx = h // 2 + int(rng.integers(-5, 6)), w // 2
        gt = (((yy - cy) ** 2 + (xx - cx) ** 2 < (min(h, w) * 0.45) ** 2)
              * 255).astype(np.uint8)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        img[gt > 0] = img[gt > 0] // 3 + (150, 40, 30)
        cv2.imwrite(str(root / "images" / f"v{i:02d}.png"), img)
        cv2.imwrite(str(root / "GT" / f"v{i:02d}.png"), gt)
    return str(root)


def _sweep_pair(val_tree):
    port = resident.build_resident_val_dataset(
        pl.SalData(val_tree, (48, 48), mode="val"), (48, 48), 4,
        device="cpu", with_wf_tables=True)
    ref = jres.build_resident_val_dataset(
        jpl.SalData(val_tree, (48, 48), mode="val"), (48, 48), 4,
        with_wf_tables=True)
    canvas = port.pop("_canvas_hw")
    assert ref.pop("_canvas_hw") == canvas
    return port, ref, canvas


def _assert_results_close(got, want, scalar=1e-4, curve=2e-4, wf=5e-4):
    for k in ("mae", "max_f", "adaptive_f", "adaptive_e", "s_measure"):
        assert got[k] == pytest.approx(want[k], abs=scalar), k
    assert got["weighted_f"] == pytest.approx(want["weighted_f"], abs=wf)
    for k in ("precision", "recall", "emeasure"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=curve,
                                   err_msg=k)


def test_resident_salmetric_and_val_match_jax(val_tree, calibrated):
    """The TESTALL sweep and the val MAE on the port's CSNet against the
    JAX package's on the same weights and the same uint8 stores, at the JAX
    test's bars."""
    model, params = calibrated
    port, ref, canvas = _sweep_pair(val_tree)
    es = make_eval_step(model, from_u8=True)
    jes = jstep.make_eval_step(jinit_layers(8, [0.5, 0.5]), from_u8=True)
    sums = resident.make_resident_salmetric_fn(
        es, batch_size=4, canvas_hw=canvas)(port)
    assert sums["p_sum"].shape == (3, 256) and sums["n"].shape == (3,)
    got = result_from_sums(sums)
    want = jsal.result_from_sums(jres.make_resident_salmetric_fn(
        jes, batch_size=4, canvas_hw=canvas)(params, ref))
    assert got["mae"] > 0.01 and 0.0 < got["max_f"] < 1.0  # not degenerate
    _assert_results_close(got, want)

    val = resident.make_resident_val_fn(es, batch_size=4, canvas_hw=canvas)
    jval = jres.make_resident_val_fn(jes, batch_size=4, canvas_hw=canvas)
    mae = val(port)
    assert mae.ndim == 0
    assert mae.item() == pytest.approx(float(jval(params, ref)), abs=1e-4)
    assert mae.item() == pytest.approx(got["mae"], abs=1e-6)


def test_resident_salmetric_matches_jax_on_the_same_maps(val_tree,
                                                         calibrated):
    """The port's sweep fed the JAX package's forward: everything after the
    forward (resize back, quantization, every metric) within 1e-5."""
    _, params = calibrated
    port, ref, canvas = _sweep_pair(val_tree)
    jes = jstep.make_eval_step(jinit_layers(8, [0.5, 0.5]), from_u8=True)

    def jax_forward(img):
        return torch.from_numpy(np.array(jes(params, jnp.asarray(
            img.numpy()))))

    got = result_from_sums(resident.make_resident_salmetric_fn(
        jax_forward, batch_size=4, canvas_hw=canvas)(port))
    want = jsal.result_from_sums(jres.make_resident_salmetric_fn(
        jes, batch_size=4, canvas_hw=canvas)(params, ref))
    _assert_results_close(got, want, scalar=1e-5, curve=1e-5, wf=1e-5)


def test_resident_epoch_equals_the_step_loop(png_tree, calibrated):
    """An epoch driven by one generator equals the port's own loop over the
    same permutation and draws, taken from a generator with that seed in
    the same order: losses, penalties and the final weights."""
    model, _ = calibrated
    store = resident.build_resident_dataset(
        pl.SalData(png_tree, (48, 48)), (64, 64), device="cpu")
    runs = []
    for use_epoch_fn in (True, False):
        m = CSNet(model.lc, device="cpu")
        m.load_state_dict(model.state_dict())
        step = make_train_step(m, make_adam(m), flops_weight=3.0,
                               batch_size=2)
        gen = torch.Generator().manual_seed(21)
        if use_epoch_fn:
            epoch = resident.make_resident_epoch_fn(
                step, batch_size=2, out_hw=(48, 48), max_crop=9)
            losses, pens = epoch(store, gen, 1e-3, 1.0)
        else:
            perm = torch.randperm(6, generator=gen).reshape(3, 2)
            valid = torch.tensor([[64, 64]]).expand(2, 2)
            out = []
            for idxs in perm:
                draws = dp.draw_augment_params(gen, 2, 9)
                batch = dp.preprocess_train_batch(
                    store["image_u8"][idxs], store["gt_u8"][idxs], valid,
                    draws=draws, out_hw=(48, 48))
                out.append(step(batch, 1e-3, 1.0))
            losses = torch.stack([o["loss"] for o in out])
            pens = torch.stack([o["penalty"] for o in out])
        runs.append((losses, pens, m.state_dict()))
    (l1, p1, s1), (l2, p2, s2) = runs
    assert l1.shape == (3,) and torch.isfinite(l1).all() and (p1 > 0).all()
    torch.testing.assert_close(l1, l2, rtol=0, atol=0)
    torch.testing.assert_close(p1, p2, rtol=0, atol=0)
    for k, v in s1.items():
        torch.testing.assert_close(v, s2[k], rtol=0, atol=0, msg=k)
