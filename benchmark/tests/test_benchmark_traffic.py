"""The traffic generator and the load generator, on the CPU at a tiny
size: the schedule gives every seed the same work in another order, the
percentiles take every request, and the load generator's process runs an
open and a closed loop against a stub server and counts what it sent."""

import http.server
import io
import os
import threading

import numpy as np
import pytest

from benchmark import traffic as tr
from benchmark.serve_cell import LoadGen

OPEN = {"kind": "serve", "loop": "open", "sizes": [1, 2, 4, 8, 16],
        "rate_img_s": 310, "pool": 12}


def test_every_seed_gets_the_same_work_in_another_order():
    a = tr.open_schedule(OPEN, 2**33 + 5, 4.0)
    b = tr.open_schedule(OPEN, 7, 4.0)
    assert len(a) == len(b) == 200          # 310 img/s * 4 s / 6.2
    assert sorted(len(i) for _, i in a) == sorted(len(i) for _, i in b)
    gaps = lambda s: np.diff([0.0] + [t for t, _ in s])  # noqa: E731
    assert np.allclose(np.sort(gaps(a)), np.sort(gaps(b)))
    assert [len(i) for _, i in a] != [len(i) for _, i in b]
    assert a == tr.open_schedule(OPEN, 2**33 + 5, 4.0)
    assert a[-1][0] == pytest.approx(4.0)
    assert all(0 <= j < OPEN["pool"] for _, i in a for j in i)
    # the gaps' mean is the rate's
    assert np.mean(gaps(a)) == pytest.approx(4.0 / 200)


def test_percentile_takes_every_request():
    v = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert tr.percentile(v, 50) == 3.0
    assert tr.percentile(v, 95) == pytest.approx(4.8)
    assert tr.percentile(v, 95) == pytest.approx(np.percentile(v, 95))
    # a failed request misses every limit
    assert tr.percentile([1.0, 2.0, float("inf")], 95) == float("inf")
    assert tr.percentile([1.0, 2.0, 3.0, float("inf")], 50) == 2.5


class _Stub(http.server.BaseHTTPRequestHandler):
    """Answers /predict with the mean of each image as a uint8 map."""

    def log_message(self, *a):
        pass

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        x = np.load(io.BytesIO(body))
        out = np.broadcast_to(x.mean(axis=(1, 2, 3), keepdims=True)
                              .astype(np.uint8)[..., :1],
                              x.shape[:3] + (1,)).copy()
        buf = io.BytesIO()
        np.save(buf, out)
        data = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.mark.parametrize("traffic", [
    OPEN, {"kind": "serve", "loop": "closed", "clients": 2, "sizes": [1, 3],
           "pool": 12}], ids=["open", "closed"])
def test_loadgen_process_runs_a_window(tmp_path, traffic):
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    seed, hw, seconds = 2**31 + 9, 8, 1.0
    params = {"traffic": traffic, "seed": seed, "seconds": seconds, "hw": hw,
              "minmax": os.path.join(tmp_path, "maps.npz")}
    lg = LoadGen(params)
    try:
        lg.ready()
        lg.go(srv.server_address[:2])
        res = lg.result()
    finally:
        lg.close()
        srv.shutdown()
        srv.server_close()
    assert res["failed"] == 0 and not res["errors"]
    assert all(v is not None and v > 0 for v in res["latency_ms"])
    if traffic["loop"] == "open":
        sched = tr.open_schedule(traffic, seed, seconds)
        assert res["attempted"] == len(sched) == 50
        assert len(res["lateness_ms"]) == len(sched)
    else:
        assert res["attempted"] > 4
    maps = np.load(params["minmax"])
    pool = tr.make_pool(seed, traffic["pool"], hw)
    seen = np.flatnonzero(maps["seen"])
    assert seen.size
    want = pool.mean(axis=(1, 2, 3)).astype(np.uint8)
    for i in seen:       # every response landed on its own image
        assert (maps["lo"][i] == want[i]).all()
        assert (maps["hi"][i] == want[i]).all()
