"""HTTP serving daemon over serving artifacts, with dynamic micro-batching.

Port of ``sod100k_tpu/serve_http.py`` over this package's ``ServingModel``.
Batching is where the throughput is, and the u8 wire quarters request and
response traffic.

Design:
  - ONE dispatcher thread owns the device. HTTP handler threads only
    decode/encode bytes and park on a per-request event, so concurrent
    clients never contend on the device and every device dispatch is one
    batched forward.
  - Dynamic micro-batching: the dispatcher takes the first queued request,
    then keeps draining for at most ``max_wait_ms`` or until the largest
    shape bucket is covered, concatenates, runs the ServingModel once (its
    bucket routing pads/chunks), and scatters results back.
  - Startup warm-up runs every bucket once, so the first client does not
    pay for kernel builds, cuDNN algorithm selection or allocator growth.
  - Error responses sent before the request body was read in full carry
    ``Connection: close``: the unread body must never be parsed as the next
    request on a kept-alive connection.

Endpoints:
  GET  /healthz   -> {"ok": true, ...artifact meta}
  GET  /stats     -> requests/images/dispatches + per-dispatch batch histogram
  POST /predict
       Content-Type: application/x-npy  — body is a .npy array (N,H,W,3) or
           (H,W,3) on the artifact's wire contract (uint8 RGB for wire="u8",
           normalized float32 otherwise); response is a .npy saliency array.
       Content-Type: image/*            — body is an encoded image (PNG
           without any library, JPEG through PIL where it is installed); it
           is resized to the artifact's spatial size and normalized per the
           wire; response is a PNG saliency map.
"""

from __future__ import annotations

import io
import json
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .data.image_io import decode_image, encode_png, resize_u8_linear
from .data.pipeline import IMAGENET_MEAN, IMAGENET_STD, rgb_u8

# request-body cap: the largest legitimate request (a full f32 bucket,
# e.g. 128 x 336^2 x 3 f32 ~ 174 MB) fits with headroom; anything bigger
# gets 413 instead of an unbounded read into memory
MAX_BODY_BYTES = 1 << 30


class DispatchError(RuntimeError):
    """Device/model failure inside a batched dispatch. Server-side by
    definition (the client's request already passed validate()), so the
    HTTP layer maps it to 500 — never to a 400 protocol error, even when
    the underlying model raised a ValueError."""


class _Request:
    __slots__ = ("images", "event", "result", "error")

    def __init__(self, images: np.ndarray):
        self.images = images
        self.event = threading.Event()
        self.result = None
        self.error: Exception | None = None


class Batcher:
    """Queue + single dispatcher thread over a ServingModel.

    ``submit(images)`` blocks the calling thread until its slice of a
    batched device dispatch returns. All model calls happen on the one
    worker thread; submitters only validate, enqueue and wait.
    """

    def __init__(self, model, *, max_wait_ms: float = 3.0):
        self.model = model
        self.max_wait_s = max_wait_ms / 1e3
        self.max_batch = int(model.batches[-1])
        self._queue: list[_Request] = []
        self._cond = threading.Condition()
        self._stopped = False
        self.stats = {"requests": 0, "images": 0, "dispatches": 0,
                      "batch_hist": {}}
        self._stats_lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-dispatcher")
        self._thread.start()

    # -- client side ------------------------------------------------------
    def validate(self, images: np.ndarray) -> np.ndarray:
        """Shape/dtype checks raised HERE (client thread) so protocol errors
        become HTTP 400s instead of poisoning a batched dispatch."""
        arr = np.asarray(images)
        if arr.ndim != 4 or arr.shape[0] < 1:
            raise ValueError(f"expected (N,H,W,3) images, got {arr.shape}")
        want = self.model.input_shape[1:]
        if tuple(arr.shape[1:]) != tuple(want):
            raise ValueError(
                f"spatial/channel shape {arr.shape[1:]} does not match the "
                f"artifact's {want} (exported shapes are the contract)")
        if self.model.meta.get("wire", "f32") == "u8":
            if not np.issubdtype(arr.dtype, np.integer):
                raise ValueError(
                    f"wire='u8' artifact expects raw uint8 RGB, got dtype "
                    f"{arr.dtype}")
            if arr.dtype != np.uint8 and arr.size and (
                    arr.min() < 0 or arr.max() > 255):
                # never silently wrap (int32 300 -> 44 would 200-OK garbage)
                raise ValueError(
                    f"wire='u8' pixel values must be in [0, 255]; got "
                    f"[{arr.min()}, {arr.max()}] ({arr.dtype})")
            return arr.astype(np.uint8)
        return arr.astype(np.float32)

    def submit(self, images: np.ndarray, timeout_s: float = 60.0):
        req = _Request(self.validate(images))
        with self._cond:
            if self._stopped:
                raise RuntimeError("batcher is stopped")
            self._queue.append(req)
            self._cond.notify()
        if not req.event.wait(timeout_s):
            with self._cond:
                try:  # still queued: pull it so it cannot consume a later
                    self._queue.remove(req)  # dispatch nobody will read
                except ValueError:
                    pass  # already taken into a group; result is dropped
            raise TimeoutError(f"no dispatch within {timeout_s}s")
        if req.error is not None:
            raise req.error
        return req.result

    # -- dispatcher side --------------------------------------------------
    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=10)

    def warmup(self) -> None:
        """Run every shape bucket once."""
        h, w = self.model.input_shape[1:3]
        u8 = self.model.meta.get("wire", "f32") == "u8"
        for b in self.model.batches:
            x = np.zeros((b, h, w, 3),
                         np.uint8 if u8 else np.float32)
            self.model(x)

    def _take_group(self) -> list[_Request] | None:
        with self._cond:
            while not self._queue and not self._stopped:
                self._cond.wait()
            if self._stopped and not self._queue:
                return None
            group = [self._queue.pop(0)]
            size = group[0].images.shape[0]
            deadline = time.monotonic() + self.max_wait_s
            # keep draining until the largest bucket is covered or the
            # batching window closes
            while size < self.max_batch:
                if self._queue:
                    nxt = self._queue[0]
                    if size + nxt.images.shape[0] > self.max_batch:
                        break
                    group.append(self._queue.pop(0))
                    size += nxt.images.shape[0]
                    continue
                left = deadline - time.monotonic()
                if left <= 0 or self._stopped:
                    break
                self._cond.wait(timeout=left)
            return group

    def _dispatch(self, group: list, sizes: list, batch) -> None:
        try:
            out = self.model(batch)
            off = 0
            for r, n in zip(group, sizes):
                r.result = out[off:off + n]
                off += n
        except Exception as e:  # scatter the failure, keep serving — one
            for r in group:  # FRESH exception per request (re-raising a
                # shared instance concurrently mutates its __traceback__),
                # typed DispatchError so the HTTP layer keeps it a 500
                r.error = DispatchError(f"{type(e).__name__}: {e}")
        finally:
            with self._stats_lock:
                self.stats["requests"] += len(group)
                self.stats["images"] += sum(sizes)
                self.stats["dispatches"] += 1
                h = self.stats["batch_hist"]
                h[sum(sizes)] = h.get(sum(sizes), 0) + 1
            for r in group:
                r.event.set()

    @staticmethod
    def _concat(group: list):
        return (group[0].images if len(group) == 1 else
                np.concatenate([r.images for r in group]))

    def _run(self) -> None:
        while True:
            group = self._take_group()
            if group is None:
                return
            self._dispatch(group, [r.images.shape[0] for r in group],
                           self._concat(group))

    def snapshot(self) -> dict:
        with self._stats_lock:
            s = dict(self.stats)
            s["batch_hist"] = dict(self.stats["batch_hist"])
        return s


def _decode_image_request(body: bytes, model) -> np.ndarray:
    """Encoded image -> one model-contract image (1,H,W,3): decoded as
    cv2's IMREAD_COLOR in RGB, resized with cv2's uint8 INTER_LINEAR (bit
    for bit, ``image_io.resize_u8_linear``), without cv2."""
    try:
        rgb = rgb_u8(decode_image(body, "request body"), "request body")
    except (ValueError, OSError, RuntimeError, zlib.error,
            struct.error) as e:  # OSError: PIL's unidentified image
        raise ValueError(f"request body is not a decodable image: {e}") \
            from None
    h, w = model.input_shape[1:3]
    if rgb.shape[:2] != (h, w):
        rgb = resize_u8_linear(rgb, (h, w))
    if model.meta.get("wire", "f32") == "u8":
        return rgb[None]
    x = rgb.astype(np.float32) / 255.0
    return ((x - IMAGENET_MEAN) / IMAGENET_STD)[None]


def _encode_png_saliency(sal: np.ndarray) -> bytes:
    """(H,W,1) saliency -> PNG bytes; floats use the repo-wide trunc
    quantization (data/pipeline.quantize_sigmoid_u8 semantics, host-side)."""
    m = np.asarray(sal)[..., 0]
    if not np.issubdtype(m.dtype, np.integer):
        m = np.trunc(m * 255.0)
    return encode_png(m.astype(np.uint8))


def make_server(model, host: str = "127.0.0.1", port: int = 0, *,
                max_wait_ms: float = 3.0, warmup: bool = True,
                request_timeout_s: float = 60.0) -> ThreadingHTTPServer:
    """Build (not run) the HTTP server; ``server.batcher`` is attached.
    Call ``serve_forever()`` (blocking) or drive it from a thread in tests;
    ``server.shutdown()`` + ``server.batcher.stop()`` to tear down."""
    batcher = Batcher(model, max_wait_ms=max_wait_ms)
    if warmup:
        batcher.warmup()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through one logger line
            pass

        def _send(self, code: int, ctype: str, body: bytes,
                  close: bool = False) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if close:  # also sets self.close_connection
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj, close: bool = False) -> None:
            self._send(code, "application/json",
                       json.dumps(obj).encode(), close=close)

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, {"ok": True, **model.meta})
            elif self.path == "/stats":
                self._send_json(200, batcher.snapshot())
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            ctype = (self.headers.get("Content-Type") or
                     "application/octet-stream").split(";")[0].strip()
            body = None
            try:
                # inside the try: a malformed Content-Length is a client
                # protocol error (400), not an aborted connection; negative
                # values would make read(-1) block until EOF on keep-alive
                # (thread exhaustion) and huge ones buffer unboundedly
                n = int(self.headers.get("Content-Length", 0))
                if n < 0:
                    raise ValueError(f"negative Content-Length {n}")
                if n > MAX_BODY_BYTES:
                    self._send_json(413, {
                        "error": f"body of {n} bytes exceeds the "
                                 f"{MAX_BODY_BYTES}-byte limit"}, close=True)
                    return
                body = self.rfile.read(n)
                if ctype == "application/x-npy":
                    arr = np.load(io.BytesIO(body), allow_pickle=False)
                    squeeze = arr.ndim == 3
                    out = batcher.submit(arr[None] if squeeze else arr,
                                         timeout_s=request_timeout_s)
                    buf = io.BytesIO()
                    np.save(buf, out[0] if squeeze else out)
                    self._send(200, "application/x-npy", buf.getvalue())
                elif ctype.startswith("image/") or \
                        ctype == "application/octet-stream":
                    x = _decode_image_request(body, model)
                    out = batcher.submit(x, timeout_s=request_timeout_s)
                    self._send(200, "image/png", _encode_png_saliency(out[0]))
                else:
                    self._send_json(415, {"error": f"unsupported "
                                          f"Content-Type {ctype}"})
            except (ValueError, TypeError) as e:
                # a malformed Content-Length leaves the body unread
                self._send_json(400, {"error": str(e)}, close=body is None)
            except TimeoutError as e:
                self._send_json(503, {"error": str(e)})
            except Exception as e:  # dispatch-side failure
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.batcher = batcher
    return srv
