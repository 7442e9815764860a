"""Smoke run of the PyTorch/CUDA port (sod100k_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives CSNet-L (``init_layers(40, [0.5, 0.5])``, full width, 224^2, seeded
random weights with calibrated BN statistics) through the port's serving
entry points, with every ILBlock depthwise tail on the hand-written CUDA
kernel (csrc/dw_chain.cu). Phases; any failure exits non-zero:

1. build the kernel with nvcc (sm_90a) and print the card's name and
   power limit;
2. kernel against its plain PyTorch version on the card, at the main path's
   shapes, at ragged ones and at one shape on each launch plan's edge: f32
   within atol 2e-5, bf16 within one bf16 ulp (rtol 2^-7, atol 1e-3), each
   of a value the plain function may give (in bf16 an intermediate at a
   rounding tie may round either way: ``dw_chain.check_against_plain``);
3. the model in f32 on the card (kernel path) against the port on the CPU
   (plain path): max |dlogit| < 1e-3, sigmoid mean |d| < 1e-5, 33 kernel
   launches per forward, a sigmoid that is not constant;
4. serving: a bf16 u8-wire artifact with buckets (1, 8, 32), the HTTP
   daemon on 127.0.0.1, 16 requests from 4 client threads, /stats and the
   launch count; each response is nearer its own images' direct
   ServingModel result than any other request's. In bf16 a cuDNN algorithm
   that changes with the bucket flips single bf16 roundings, which the
   fresh x100 net amplifies to most pixels, so the served-vs-direct bar
   (within 1 level on at most 0.1% of pixels) is held by
4b. the same with an f32-compute artifact, which is batch-invariant;
5. at N=32 for each main-path shape, the kernel held against the plain
   version in bf16 and f32 as in phase 2, then times (not gated): the kernel's
   device time per call (torch.profiler self device time of the kernel
   over 20 launches of ``fused_dw_chain_packed``, with CUDA events around
   the same loop as a cross-check), the wrapper's host time per call, the
   bound and the share of it, the plain version, and one bf16 depthwise
   ``F.conv2d`` (one stage, no BN or PReLU) as a yardstick; then the B=32
   bf16 eval forward (host clock, synchronized) with the profiler's device
   time split by kernel, and direct ServingModel img/s at B=32.

Needs torch with CUDA and nvcc; no jax, cv2 or yaml. The second line from
the end is a JSON summary of the kernels; the last line is the run's JSON
result.

    python3 chip_smoke.py --variants

runs phase 1 and then an A/B of the kernel's plan sizes and of diagnostic
builds of its source (arithmetic, staging copies or stores of y taken out),
timed as in phase 5 and printed per shape and per forward; no result line.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from sod100k_tpu_torch.arch.csnet import CSNet, calibrate_bn
from sod100k_tpu_torch.arch.layer_config import init_layers
from sod100k_tpu_torch.data.pipeline import normalize_u8
from sod100k_tpu_torch.ops import cuda_lib, dw_chain
from sod100k_tpu_torch.serve import export_artifact, load_artifact
from sod100k_tpu_torch.serve_http import make_server
from sod100k_tpu_torch.train.step import make_eval_step

HW = (224, 224)
CALLS_PER_FORWARD = 33
# (H, W, C) of the 33 fused-tail calls of one CSNet-L forward at 224^2, with
# how many calls use each shape
MAIN_SHAPES = [((224, 224, 20), 4), ((112, 112, 20), 4), ((112, 112, 40), 3),
               ((56, 56, 40), 3), ((112, 112, 80), 1), ((56, 56, 80), 5),
               ((28, 28, 80), 8), ((14, 14, 80), 3), ((56, 56, 160), 1),
               ((28, 28, 160), 1)]
RAGGED_SHAPES = [(2, 40, 36, 13), (1, 17, 23, 5), (2, 64, 64, 24)]  # NHWC
EDGE_SHAPES = [(3, 9, 14, 14),    # odd plane count at 14^2 (NCHW)
               (2, 3, 101, 224),  # H not a multiple of the band rows
               (1, 1, 224, 224),  # the band path with a single plane
               (2, 3, 170, 102)]   # rows not 16-byte aligned
HBM_BYTES_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_S = 67e12    # H100 SXM float32 outside the tensor cores
FLOPS_PER_ELEMENT = 2 * (9 + 9 + 2 + 1)  # two stages: taps, scale+shift, PReLU
L2_BYTES = 50e6
TOL = {torch.float32: dict(rtol=0.0, atol=2e-5),
       torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-3)}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def say(msg: str) -> None:
    print(msg, flush=True)


def chain_inputs(n, c, h, w, dtype, rng):
    """Seeded activation (N, C, H, W) and both stages' taps (C, 3, 3) and
    scale/shift/alpha (C,), the recipe of the JAX package's kernel test."""
    x = torch.from_numpy(rng.standard_normal((n, c, h, w), dtype=np.float32))
    params = []
    for _ in range(2):
        params += [rng.standard_normal((c, 3, 3), dtype=np.float32) * 0.1,
                   rng.random(c).astype(np.float32) + 0.5,
                   rng.standard_normal(c).astype(np.float32),
                   rng.standard_normal(c).astype(np.float32) * 0.25]
    return (x.to("cuda", dtype),
            [torch.from_numpy(np.ascontiguousarray(p)).cuda() for p in params])


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel(got, x, params, what: str) -> float:
    """Hold the kernel's result against the plain version at TOL: within the
    bar of a value the plain function may give, where a bf16 intermediate
    at a rounding tie may round either way (the kernel and cuDNN sum the
    taps in different orders). Returns the largest distance."""
    check(got.dtype == x.dtype and got.shape == x.shape,
          f"kernel output {got.dtype} {tuple(got.shape)}")
    plain = dw_chain.fused_dw_chain_ref(x, *params)
    e, ties = dw_chain.check_against_plain(got, x, params, **TOL[x.dtype])
    say(f"  kernel vs plain {str(x.dtype)[6:]:8s} NCHW {what}: max |d| "
        f"{(got.float() - plain.float()).abs().max().item():.3e} from the "
        f"plain version, {e:.3e} from its range ({ties} intermediates near a "
        f"rounding tie)")
    return e


def phase_kernel_vs_plain() -> dict:
    cases = [(2, c, h, w) for (h, w, c), _ in MAIN_SHAPES]
    cases += [(n, c, h, w) for n, h, w, c in RAGGED_SHAPES] + EDGE_SHAPES
    rng = np.random.default_rng(0)
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in cases:
            x, params = chain_inputs(*shape, dtype, rng)
            got = dw_chain.fused_dw_chain(x, *params)
            torch.cuda.synchronize()
            err[dtype] = max(err[dtype], check_kernel(got, x, params,
                                                      str(shape)))
    return err


def phase_model_f32(model_cpu: CSNet, images: np.ndarray) -> None:
    x = normalize_u8(torch.from_numpy(images))
    with torch.no_grad():
        want = model_cpu(x).numpy()
    model = CSNet(model_cpu.lc, device="cuda")
    model.load_state_dict(model_cpu.state_dict(), strict=True)
    model.eval()
    dw_chain.launches = 0
    with torch.no_grad():
        got = model(x.cuda())
    torch.cuda.synchronize()
    launches = dw_chain.launches
    got = got.cpu().numpy()
    check(launches == CALLS_PER_FORWARD,
          f"{launches} kernel launches in one forward, want {CALLS_PER_FORWARD}")
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    d_logit = float(np.abs(got - want).max())
    d_sig = float(np.abs(sig(got) - sig(want)).mean())
    say(f"  f32 card (kernel) vs CPU (plain), 2x224^2: max |dlogit| "
        f"{d_logit:.3e} (< 1e-3), sigmoid mean |d| {d_sig:.3e} (< 1e-5), "
        f"sigmoid std {sig(got).std():.4f}, launches {launches}")
    check(got.shape == (2, *HW, 1) and np.isfinite(got).all(), "f32 output")
    check(d_logit < 1e-3 and d_sig < 1e-5, "f32 card vs CPU parity")
    check(sig(got).std() > 0.01, "sigmoid is not constant")


def post_npy(url: str, arr: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url + "/predict", data=buf.getvalue(),
                                 headers={"Content-Type": "application/x-npy"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        check(r.status == 200, f"/predict status {r.status}")
        return np.load(io.BytesIO(r.read()))


def phase_serving(model_cpu: CSNet, artifact: str, dtype: torch.dtype):
    """Export, load on the card, serve 16 requests from 4 client threads,
    check /stats, the launch count and every response against a direct
    ServingModel call on the same images."""
    export_artifact(artifact, model_cpu, batch=(1, 8, 32), hw=HW,
                    dtype=dtype, wire="u8")
    sm = load_artifact(artifact, device="cuda")
    rng = np.random.default_rng(2)
    requests = [rng.integers(0, 256, (int(rng.integers(1, 5)), *HW, 3),
                             np.uint8) for _ in range(16)]
    responses: list = [None] * len(requests)
    errors: list = []

    dw_chain.launches = 0
    srv = make_server(sm, host="127.0.0.1", port=0, warmup=True)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def client(k: int) -> None:
        try:
            for i in range(k, len(requests), 4):
                responses[i] = post_npy(url, requests[i])
        except Exception as e:  # reported below, after every thread joined
            errors.append(e)

    try:
        clients = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in clients), "clients finished")
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        torch.cuda.synchronize()
        served_launches = dw_chain.launches
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.stop()
        server.join(timeout=60)
    check(not server.is_alive(), "server thread stopped")
    if errors:
        raise errors[0]

    n_images = sum(len(r) for r in requests)
    hist = {int(k): v for k, v in stats["batch_hist"].items()}
    say(f"  served {stats['requests']} requests, {stats['images']} images in "
        f"{stats['dispatches']} dispatches, batch histogram {hist}")
    check(stats["requests"] == len(requests) and stats["images"] == n_images,
          "/stats request and image counts")
    check(sum(hist.values()) == stats["dispatches"]
          and sum(k * v for k, v in hist.items()) == n_images,
          "/stats batch histogram adds up")
    forwards = len(sm.batches) + stats["dispatches"]  # warm-up + one each
    say(f"  launches over the served phase: {served_launches} "
        f"(want {CALLS_PER_FORWARD} x {forwards})")
    check(served_launches == CALLS_PER_FORWARD * forwards,
          "launches over the served phase")

    directs = [sm(req) for req in requests]
    worst_share, worst_max = 0.0, 0
    for i, (resp, direct) in enumerate(zip(responses, directs)):
        check(resp.shape == direct.shape == (len(requests[i]), *HW, 1)
              and resp.dtype == np.uint8, "response shape and dtype")
        diff = np.abs(resp.astype(np.int32) - direct.astype(np.int32))
        worst_share = max(worst_share, float((diff > 0).mean()))
        worst_max = max(worst_max, int(diff.max()))
        if dtype == torch.float32:
            check(diff.max() <= 1 and (diff > 0).mean() <= 1e-3,
                  f"served vs direct: max |d| {diff.max()}, "
                  f"share {(diff > 0).mean():.2e}")
        else:
            # bf16 on fresh weights is chaotic across buckets (PERF.md): the
            # check is that each client got its own images' maps back
            own = np.abs(resp[0].astype(np.int32) - direct[0]).mean()
            others = min(np.abs(resp[0].astype(np.int32) - d[0]).mean()
                         for j, d in enumerate(directs) if j != i)
            check(own < others, f"response {i} is nearer another request's "
                  f"map ({others:.2f}) than its own ({own:.2f})")
    say(f"  {str(dtype)[6:]} served vs direct: worst max |d| {worst_max} "
        f"levels, worst share of pixels that differ {worst_share:.2e}")
    return sm, served_launches


def device_ms(fn, match: str | None = None, iters: int = 20) -> float:
    """Device time per call of ``fn``: torch.profiler's self device time of
    the kernels whose name holds ``match`` (every kernel if None), over
    ``iters`` calls, after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler has been seen to drop a whole window
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for e in prof.key_averages():
            if match is None or match in e.key:
                total += e.self_device_time_total
                count += e.count
        if total > 0 and (match is None or count == iters):
            return total / iters / 1e3
    raise RuntimeError(f"check failed: the profiler saw {count} {match} "
                       f"kernels in {iters} calls")


def host_us(fn, iters: int = 20) -> float:
    """Host time per call of ``fn`` (the enqueue, not the device work)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def phase_times(sm, gpu: str) -> dict:
    rng = np.random.default_rng(3)
    tot = dict.fromkeys(("device", "events", "host", "bound", "plain",
                         "library", "bytes_bound", "ops_bound"), 0.0)
    for (h, w, c), calls in MAIN_SHAPES:
        x, params = chain_inputs(32, c, h, w, torch.bfloat16, rng)
        packed = dw_chain.pack_params(*params)
        plan = dw_chain.device_plan(32, c, h, w, torch.bfloat16, 0)
        fused = lambda: dw_chain.fused_dw_chain_packed(x, packed)  # noqa: E731
        # the plans the forward runs, walks of several items a block
        # included, against the plain version
        check_kernel(fused(), x, params, f"(32, {c}, {h}, {w})")
        x32 = x.float()
        check_kernel(dw_chain.fused_dw_chain_packed(x32, packed), x32,
                     params, f"(32, {c}, {h}, {w})")
        del x32
        plain = lambda: dw_chain.fused_dw_chain_ref(x, *params)  # noqa: E731
        wdw = params[0].reshape(c, 1, 3, 3).to(torch.bfloat16)
        lib = lambda: torch.nn.functional.conv2d(  # noqa: E731
            x, wdw, padding=1, groups=c)
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(fused), cuda_ms(fused), \
            cuda_ms(plain)
        dev = device_ms(fused, match="dw_chain_kernel")
        lib_ms = device_ms(lib)
        host = host_us(fused)
        nbytes = 2 * x.numel() * x.element_size()  # read x, write y
        bytes_bound = nbytes / HBM_BYTES_S * 1e3
        ops_bound = x.numel() * FLOPS_PER_ELEMENT / F32_FLOPS_S * 1e3
        bound = max(bytes_bound, ops_bound)
        row = dict(device=dev, events=(k1 + k2) / 2, host=host, bound=bound,
                   plain=(p1 + p2) / 2, library=lib_ms,
                   bytes_bound=bytes_bound, ops_bound=ops_bound)
        for k in tot:
            tot[k] += calls * row[k]
        l2 = "fits in" if nbytes <= L2_BYTES else "exceeds"
        say(f"  N=32 bf16 ({h},{w},{c}) x{calls} [{plan.variant}, "
            f"{plan.copy}, planes {plan.planes}, rows {plan.rows}, vec "
            f"{plan.vec}, block {plan.block}, grid {plan.grid}, smem "
            f"{plan.smem}]: device {dev * 1e3:.2f} us (events "
            f"{row['events'] * 1e3:.2f} us), host {host:.1f} us, bound "
            f"{bound * 1e3:.2f} us ({bound / dev:.1%} of it), plain "
            f"{row['plain']:.4f} ms, library_ms (one-stage bf16 depthwise "
            f"conv2d, not the same function) {lib_ms:.4f} ms; x + y "
            f"{nbytes / 1e6:.1f} MB {l2} the 50 MB L2 between calls  [{gpu}]")
    say(f"  per B=32 forward (33 calls): kernel device {tot['device']:.4f} ms "
        f"(events {tot['events']:.4f} ms), bound {tot['bound']:.4f} ms "
        f"({tot['bound'] / tot['device']:.1%} of it), host "
        f"{tot['host']:.0f} us, plain {tot['plain']:.4f} ms, one-stage "
        f"conv2d yardstick {tot['library']:.4f} ms  [{gpu}]")

    images = rng.integers(0, 256, (32, *HW, 3), np.uint8)
    step = make_eval_step(sm.model, from_u8=True,
                          compute_dtype=torch.bfloat16)
    xu8 = torch.from_numpy(images).cuda()
    for _ in range(3):
        step(xu8)
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        step(xu8)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) / reps * 1e3
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step(xu8)
        torch.cuda.synchronize()
    kernels = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    dev_fwd = sum(e.self_device_time_total for e in kernels) / 5 / 1e3
    say(f"  eval forward B=32 bf16 224^2, u8 on the card: {fwd_ms:.3f} ms per "
        f"forward (host clock, 20 forwards, synchronized), device "
        f"{dev_fwd:.3f} ms ({1 - dev_fwd / fwd_ms:.1%} idle)  [{gpu}]")
    for e in kernels[:14]:
        t = e.self_device_time_total / 5 / 1e3
        say(f"    {t:8.4f} ms {t / dev_fwd:6.1%} {e.count / 5:6.1f}/fwd  "
            f"{e.key[:110]}")

    for _ in range(3):
        sm(images)
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        sm(images)
    dt = time.perf_counter() - t0
    say(f"  direct ServingModel B=32 bf16 u8 wire: {reps * 32 / dt:.1f} img/s "
        f"({dt / reps * 1e3:.2f} ms per call)  [{gpu}]")
    return tot


# --variants: A/B of the kernel's plan sizes (module constants of
# ops/dw_chain.py, for every shape or by H) and diagnostic builds of the
# source that compute the wrong thing on purpose, to show which part bounds
# the kernel
VARIANTS = {
    "default": {},
    "diag: no arithmetic": {"patch": [(
        "    float v = acc * s + sh;", "    float v = b[i + 1]; (void)acc;")]},
    "diag: no staging copies": {"patch": [
        ("  it.bulk = s.bulk && ", "  it.bulk = false && "),
        ("      for (int i = tid; i < it.count; i += nthreads) in[i] = src[i];",
         "      (void)src;")]},
    "diag: no stores of y": {"patch": [(
        "  *reinterpret_cast<Vec<T, V>*>(out) = o;",
        "  if (__isShared(out) || to_f32(o.v[0]) == 12345.f)\n"
        "    *reinterpret_cast<Vec<T, V>*>(out) = o;")]},
    "128 threads": {"all": {"BAND_THREADS": 128, "PLANE_THREADS": 128}},
    "224 threads": {"all": {"BAND_THREADS": 224, "PLANE_THREADS": 224}},
    "two slots everywhere": {"all": {"PLANE_SLOTS": 2}},
    "one slot everywhere": {"all": {"BAND_SLOTS": 1}},
    "224^2 bands of 48 rows": {224: {"BAND_BYTES": 52 * 224 * 2}},
    "112^2 as bands of 56 rows": {112: {"PLANE_BYTES": 0,
                                        "BAND_BYTES": 60 * 112 * 2}},
    "56^2 one plane per item": {56: {"ITEM_BYTES": 56 * 56 * 2}},
    "56^2 two planes per item": {56: {"ITEM_BYTES": 2 * 56 * 56 * 2}},
    "28^2 two, 14^2 eighteen planes per item": {
        28: {"ITEM_BYTES": 2 * 28 * 28 * 2},
        14: {"ITEM_BYTES": 20 * 14 * 14 * 2, "ITEMS_PER_SM": 1}},
}


def build_patched(name: str, patch) -> ctypes.CDLL:
    """``csrc/dw_chain.cu`` with ``patch`` (a list of (old, new)) applied,
    built into ``_build/variants/``."""
    with open(os.path.join(cuda_lib.CSRC_DIR, "dw_chain.cu")) as f:
        src = f.read()
    for old, new in patch:
        check(old in src, f"variant {name!r}: patch target in the source")
        src = src.replace(old, new)
    stem = os.path.join(cuda_lib.BUILD_DIR, "variants",
                        "".join(ch if ch.isalnum() else "_" for ch in name))
    os.makedirs(os.path.dirname(stem), exist_ok=True)
    with open(stem + ".cu", "w") as f:
        f.write(src)
    subprocess.run([cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                    stem + ".so", stem + ".cu"], capture_output=True,
                   check=True)
    return dw_chain.bind(ctypes.CDLL(stem + ".so"))


def phase_variants(gpu: str) -> None:
    """Device ms per call of each variant at each main-path shape (N=32,
    bf16), best of two runs taken in the order A..Z, Z..A, and the sum
    over the 33 calls of a forward."""
    names = list(VARIANTS)
    patched = [n for n in names if "patch" in VARIANTS[n]]
    with concurrent.futures.ThreadPoolExecutor(len(patched)) as ex:
        libs = dict(zip(patched, ex.map(
            lambda n: build_patched(n, VARIANTS[n]["patch"]), patched)))
    default_lib = dw_chain._lib
    sizes0 = {k: getattr(dw_chain, k) for k in dir(dw_chain) if k.isupper()}
    rng = np.random.default_rng(4)
    totals = dict.fromkeys(names, 0.0)
    for (h, w, c), calls in MAIN_SHAPES:
        x, params = chain_inputs(32, c, h, w, torch.bfloat16, rng)
        packed = dw_chain.pack_params(*params)
        best = {}
        for name in names + names[::-1]:
            v = VARIANTS[name]
            sizes = {**v.get("all", {}), **v.get(h, {})}
            lib = libs.get(name)
            try:
                for k, val in sizes.items():
                    setattr(dw_chain, k, val)
                if lib is not None:
                    dw_chain._lib = lambda lib=lib: lib
                dw_chain.device_plan.cache_clear()
                t = device_ms(lambda: dw_chain.fused_dw_chain_packed(
                    x, packed), match="dw_chain_kernel")
            finally:
                for k, val in sizes0.items():
                    setattr(dw_chain, k, val)
                dw_chain._lib = default_lib
                dw_chain.device_plan.cache_clear()
            best[name] = min(best.get(name, t), t)
        bound = 2 * x.numel() * x.element_size() / HBM_BYTES_S * 1e6
        say(f"  ({h},{w},{c}) x{calls}, bound {bound:.2f} us, device us: "
            + "; ".join(f"{n} {t * 1e3:.2f}" for n, t in best.items()))
        for n, t in best.items():
            totals[n] += calls * t
    say(f"  per forward (33 calls), device ms  [{gpu}]:")
    for n, t in totals.items():
        say(f"    {t:.4f}  {n}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    check(sys.argv[1:] in ([], ["--variants"]), "arguments: none or --variants")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say("TF32 off for convolutions and matmuls: f32 phases run in full f32")

    say("phase 1: build")
    t0 = time.perf_counter()
    lib = cuda_lib.build("dw_chain")
    say(f"  built {lib} in {time.perf_counter() - t0:.1f} s")
    with open(f"{lib}.log") as f:
        say("  " + f.read().strip().replace("\n", "\n  "))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    say(smi)
    gpu = smi.splitlines()[0]

    if sys.argv[1:] == ["--variants"]:
        say("variants of the kernel's plans and diagnostic builds")
        phase_variants(gpu)
        return

    say("phase 2: kernel vs plain on the card")
    err = phase_kernel_vs_plain()

    say("phase 3: CSNet-L f32, card vs CPU")
    model_cpu = CSNet(init_layers(40, (0.5, 0.5)), seed=0)
    rng = np.random.default_rng(1)
    calib = rng.integers(0, 256, (4, *HW, 3), np.uint8)
    calibrate_bn(model_cpu, normalize_u8(torch.from_numpy(calib)))
    phase_model_f32(model_cpu, calib[:2])

    say("phase 4: serving, bf16 compute (the main path)")
    with tempfile.TemporaryDirectory() as artifact:
        sm, served_launches = phase_serving(model_cpu, artifact,
                                            torch.bfloat16)
    say("phase 4b: serving, f32 compute")
    with tempfile.TemporaryDirectory() as artifact:
        sm_f32, _ = phase_serving(model_cpu, artifact, torch.float32)
    x = torch.from_numpy(calib[:2])
    mae = (make_eval_step(sm.model, from_u8=True, compute_dtype=torch.bfloat16)(x)
           - make_eval_step(sm_f32.model, from_u8=True)(x)).abs().mean().item()
    say(f"  bf16 vs f32 sigmoid MAE on fresh calibrated weights: {mae:.4e} "
        f"(not gated)")

    say("phase 5: times (not gated)")
    tot = phase_times(sm, gpu)

    print(json.dumps({"kernels": [{
        "name": "fused_dw_chain", "route": "cuda",
        "source": "sod100k_tpu_torch/csrc/dw_chain.cu",
        "replaces": "sod100k_tpu/ops/pallas/dw_chain.py:125",
        "launches": served_launches,
        "max_abs_err": err[torch.float32],
        "ms": tot["device"], "plain_ms": tot["plain"],
        "bound_ms": tot["bound"], "bound_by": ("bytes" if tot["bytes_bound"] >= tot["ops_bound"]
                     else "operations"),
        "library_ms": tot["library"], "device_ms": tot["device"],
        "host_us": tot["host"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
