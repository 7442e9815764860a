"""model.mfu_pct.serve: the served forwards' share of the card's peak for
the configuration's precision: the real images' FLOPs (``flops_per_img``,
counted by ``benchmark.counts``; padding is not work) over the time of
every ``ServingModel`` call in the window."""


def read(run: dict):
    calls = run["calls"]
    busy = sum(t1 - t0 for t0, t1, *_ in calls)
    if busy <= 0:
        return None
    images = sum(n for _, _, n, *_ in calls)
    return 100.0 * images * run["flops_per_img"] / busy / run["peak_flops"]
