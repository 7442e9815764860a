"""Port parity, serving: wire math, eval step, ServingModel, HTTP daemon.

The port's eval step and artifacts against the JAX package's
``make_eval_step`` on the same calibrated weights, f32 on the CPU; bucket
padding and chunking, dtype refusal and the version guard; an HTTP round
trip; and the Connection: close fix on error responses sent before the
request body was read.
"""

import io
import json
import socket
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sod100k_tpu.data.pipeline import normalize_u8_device, quantize_sigmoid_u8
from sod100k_tpu.interop.torch_ckpt import state_dict_to_pytree
from sod100k_tpu.train.step import make_eval_step as jmake_eval_step
from sod100k_tpu_torch.arch.csnet import CSNet, calibrate_bn
from sod100k_tpu_torch.arch.layer_config import init_layers
from sod100k_tpu_torch.data import pipeline
from sod100k_tpu_torch.serve import export_artifact, load_artifact
from sod100k_tpu_torch.serve_http import make_server
from sod100k_tpu_torch.train.step import make_eval_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

HW = (32, 32)


@pytest.fixture(scope="module")
def model():
    m = CSNet(init_layers(8, (0.5, 0.5)), seed=2, device="cpu")
    rng = np.random.default_rng(0)
    calibrate_bn(m, torch.from_numpy(
        rng.standard_normal((4, *HW, 3), dtype=np.float32)))
    return m


@pytest.fixture(scope="module")
def images_u8():
    return np.random.default_rng(1).integers(0, 256, (5, *HW, 3), np.uint8)


def _f32_wire(images_u8):
    """The f32 wire's input: ImageNet-normalized float32 (host copy)."""
    return np.array(normalize_u8_device(jnp.asarray(images_u8)))


def _jax_eval(model, images, wire):
    step = jmake_eval_step(model.lc, from_u8=wire == "u8",
                           quantize_u8=wire == "u8")
    params = state_dict_to_pytree(model.state_dict())
    return np.asarray(step(params, jnp.asarray(images)))


def _check_wire_output(got, want, wire):
    assert got.shape == want.shape and got.dtype == want.dtype
    if wire == "u8":
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        # sigmoid values that agree to ~1e-6 can still sit on either side
        # of a trunc(·*255) step
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    else:
        # sigmoid of the logit bar (max |Δlogit| < 1e-3), and the mean bar
        assert np.abs(got - want).max() < 2.5e-4
        assert np.abs(got - want).mean() < 1e-5


def test_wire_math_matches_jax(images_u8):
    got = pipeline.normalize_u8(torch.from_numpy(images_u8)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(normalize_u8_device(jnp.asarray(images_u8))))
    sig = np.random.default_rng(2).random((3, 7, 5, 1), dtype=np.float32)
    sig[0, 0, 0, 0], sig[0, 0, 1, 0] = 0.0, 1.0
    np.testing.assert_array_equal(
        pipeline.quantize_sigmoid_u8(torch.from_numpy(sig)).numpy(),
        np.asarray(quantize_sigmoid_u8(jnp.asarray(sig))))


@pytest.mark.parametrize("wire", ["f32", "u8"])
def test_eval_step_matches_jax(model, images_u8, wire):
    x = images_u8 if wire == "u8" else _f32_wire(images_u8)
    step = make_eval_step(model, from_u8=wire == "u8",
                          quantize_u8=wire == "u8")
    got = step(torch.from_numpy(x)).numpy()
    _check_wire_output(got, _jax_eval(model, x, wire), wire)


@pytest.mark.parametrize("wire", ["f32", "u8"])
def test_serving_model_buckets_match_jax(model, images_u8, wire, tmp_path):
    """5 images over buckets (1, 3): one full bucket of 3, then 2 padded to
    3 by repeating the last image."""
    export_artifact(str(tmp_path), model, batch=(3, 1), hw=HW,
                    dtype=torch.float32, wire=wire)
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["batches"] == [1, 3] and meta["wire"] == wire
    sm = load_artifact(str(tmp_path), device="cpu")
    assert sm.input_shape == (3, *HW, 3)
    x = images_u8 if wire == "u8" else _f32_wire(images_u8)
    got = sm(x)
    _check_wire_output(got, _jax_eval(model, x, wire), wire)
    # one image alone takes bucket 1; the result does not depend on the
    # bucket it rode in beyond the wire's tolerance
    _check_wire_output(sm(x[4:5]), got[4:5], wire)


@pytest.mark.parametrize("wire", ["f32", "u8"])
def test_serving_replicas_split_buckets(model, images_u8, wire, tmp_path):
    """``mesh_devices=2`` (two replicas; on the CPU both live there): 5
    images over buckets (1, 4) split the bucket of 4 as 2 + 2 over the
    replicas and run the bucket of 1 on the first, and the result matches
    the JAX package at the wire's bar."""
    export_artifact(str(tmp_path), model, batch=(4, 1), hw=HW,
                    dtype=torch.float32, wire=wire)
    sm = load_artifact(str(tmp_path), device="cpu", mesh_devices=2)
    assert len(sm.models) == 2 and sm.models[0] is not sm.models[1]
    assert sm.model is sm.models[0]
    rows = []

    def counted(step, i):
        def run(x):
            rows.append((i, x.shape[0]))
            return step(x)
        return run

    sm._steps = [counted(step, i) for i, step in enumerate(sm._steps)]
    x = images_u8 if wire == "u8" else _f32_wire(images_u8)
    got = sm(x)
    assert rows == [(0, 2), (1, 2), (0, 1)]
    _check_wire_output(got, _jax_eval(model, x, wire), wire)


def test_serving_model_refusals(model, images_u8, tmp_path):
    export_artifact(str(tmp_path), model, batch=2, hw=HW,
                    dtype=torch.float32, wire="u8")
    sm = load_artifact(str(tmp_path), device="cpu")
    with pytest.raises(TypeError, match="uint8"):
        sm(images_u8.astype(np.float32) / 255.0)
    with pytest.raises(ValueError, match="expected"):
        sm(images_u8[:, :16])
    meta = json.loads((tmp_path / "meta.json").read_text())
    meta["torch_version"] = "99.0.0"
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(RuntimeError, match="re-export"):
        load_artifact(str(tmp_path), device="cpu")


def test_bf16_artifact_serves_finite_maps(model, images_u8, tmp_path):
    export_artifact(str(tmp_path), model, batch=2, hw=HW, wire="f32")
    sm = load_artifact(str(tmp_path), device="cpu")
    assert sm.meta["compute_dtype"] == "bfloat16"
    x = _f32_wire(images_u8[:2])
    out = sm(x)
    assert out.shape == (2, *HW, 1) and out.dtype == np.float32
    assert np.isfinite(out).all() and 0.0 <= out.min() <= out.max() <= 1.0
    # each parameter stays f32: activations alone run in bf16
    assert all(p.dtype == torch.float32 for p in sm.model.parameters())


def _serve(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{srv.server_address[1]}", t


def _stop(srv, t):
    srv.shutdown()
    srv.server_close()
    srv.batcher.stop()
    t.join(timeout=10)
    assert not t.is_alive()


def _post_npy(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(
        url + "/predict", data=buf.getvalue(), method="POST",
        headers={"Content-Type": "application/x-npy"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_round_trip(model, images_u8, tmp_path):
    export_artifact(str(tmp_path), model, batch=(1, 4), hw=HW,
                    dtype=torch.float32, wire="u8")
    sm = load_artifact(str(tmp_path), device="cpu")
    srv = make_server(sm, max_wait_ms=1.0)
    url, t = _serve(srv)
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert json.loads(r.read())["wire"] == "u8"
        code, body = _post_npy(url, images_u8[:3])
        assert code == 200
        got = np.load(io.BytesIO(body))
        code, body = _post_npy(url, images_u8[3])  # one (H, W, 3) image
        assert code == 200
        one = np.load(io.BytesIO(body))
        assert one.shape == (*HW, 1)
        _check_wire_output(np.concatenate([got, one[None]]),
                           sm(images_u8[:4]), "u8")
        code, _ = _post_npy(url, images_u8[:1].astype(np.float32))
        assert code == 400
        # an encoded image in, a PNG saliency map out (cv2 imported lazily)
        import cv2

        ok, png = cv2.imencode(".png", images_u8[4][:, :, ::-1])  # RGB->BGR
        req = urllib.request.Request(url + "/predict", data=png.tobytes(),
                                     headers={"Content-Type": "image/png"},
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            sal = cv2.imdecode(np.frombuffer(r.read(), np.uint8),
                               cv2.IMREAD_UNCHANGED)
        _check_wire_output(sal[None, :, :, None], sm(images_u8[4:5]), "u8")
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        assert stats["requests"] == 3 and stats["images"] == 5
        assert sum(stats["batch_hist"].values()) == stats["dispatches"]
    finally:
        _stop(srv, t)


class _FakeModel:
    batches = [2]
    input_shape = (2, 8, 8, 3)
    meta = {"family": "fake", "wire": "f32"}

    def __call__(self, x):
        return np.zeros((np.asarray(x).shape[0], 8, 8, 1), np.float32)


@pytest.mark.parametrize("length,code", [("2000000000", 413), ("-5", 400),
                                         ("abc", 400)])
def test_early_error_responses_close_connection(length, code):
    """Under HTTP/1.1 keep-alive, a response sent before the body was read
    must close the connection, or the unread body is parsed as the next
    request."""
    srv = make_server(_FakeModel(), warmup=False)
    srv.RequestHandlerClass.protocol_version = "HTTP/1.1"
    url, t = _serve(srv)
    try:
        with socket.create_connection(srv.server_address, timeout=10) as s:
            s.sendall(f"POST /predict HTTP/1.1\r\nHost: x\r\n"
                      f"Content-Type: application/x-npy\r\n"
                      f"Content-Length: {length}\r\n\r\n".encode()
                      + b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
            data = b""
            while chunk := s.recv(65536):  # EOF: the server closed
                data += chunk
        head = data.split(b"\r\n\r\n", 1)[0].decode()
        assert head.startswith(f"HTTP/1.1 {code}")
        assert "Connection: close" in head
        assert data.count(b"HTTP/1.") == 1  # the smuggled GET never ran
    finally:
        _stop(srv, t)
