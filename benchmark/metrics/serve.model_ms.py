"""serve.model_ms: median milliseconds of one ``ServingModel`` call (bucket
padding and chunking, host-to-device copy, forward, readback) over the
window's calls, timed between the batcher and the serving model."""

import statistics


def read(run: dict):
    calls = run["calls"]
    if not calls:
        return None
    return statistics.median((t1 - t0) * 1e3 for t0, t1, *_ in calls)
