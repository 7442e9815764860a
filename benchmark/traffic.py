"""The one traffic generator: requests from a traffic file and a seed.

numpy and the standard library only, since the load generator's process
imports it. A serving mix (``"kind": "serve"``) is

- ``loop``: ``"open"`` (independent users: requests sent on a schedule,
  whatever the server does) or ``"closed"`` (``clients`` callers, each
  sending its next request when the last returns);
- ``sizes``: the images per request, drawn in equal shares;
- ``rate_img_s`` (open loop): the offered images per second;
- ``pool``: the number of distinct seeded images the requests draw from.

Every seed gets the same work in another order: the open loop's request
sizes are the list ``sizes`` repeated to the request count, and its gaps
the exponential distribution's quantiles at (i + 1/2) / n, both shuffled
by the seed and the gaps scaled so that the last request is due when the
window closes. Which pool images a request carries is drawn from the seed.
"""

from __future__ import annotations

import numpy as np


def make_pool(seed: int, n: int, hw: int) -> np.ndarray:
    """``n`` seeded uint8 RGB images, (n, hw, hw, 3)."""
    rng = np.random.default_rng([seed, 0])
    return rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)


def mean_size(traffic: dict) -> float:
    return float(np.mean(traffic["sizes"]))


def open_schedule(traffic: dict, seed: int, seconds: float) -> list:
    """[(due seconds after the window opens, pool indices)] of an open
    loop over a window of ``seconds``."""
    n = max(1, int(round(traffic["rate_img_s"] * seconds
                         / mean_size(traffic))))
    rng = np.random.default_rng([seed, 1])
    sizes = np.resize(np.asarray(traffic["sizes"]), n)
    rng.shuffle(sizes)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    rng.shuffle(gaps)
    due = np.cumsum(gaps) * (seconds / gaps.sum())
    return [(float(t), tuple(int(i) for i in
                             rng.integers(0, traffic["pool"], int(s))))
            for t, s in zip(due, sizes)]


def closed_requests(traffic: dict, seed: int, client: int):
    """The endless request stream of one closed-loop client: pool indices
    of each request, sizes cycling through ``sizes``."""
    rng = np.random.default_rng([seed, 2, client])
    sizes = list(traffic["sizes"])
    k = 0
    while True:
        s = sizes[k % len(sizes)]
        k += 1
        yield tuple(int(i) for i in rng.integers(0, traffic["pool"], s))


def percentile(values, q: float) -> float:
    """The q-th percentile of all ``values``, linear between order
    statistics (numpy's default); a failed request is ``inf``."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        raise ValueError("no values")
    r = q / 100.0 * (v.size - 1)
    lo, hi = int(np.floor(r)), int(np.ceil(r))
    if lo == hi or np.isinf(v[hi]):
        return float(v[hi])
    return float(v[lo] + (v[hi] - v[lo]) * (r - lo))
