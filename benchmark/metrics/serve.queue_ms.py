"""serve.queue_ms: the mean milliseconds a request waited in the HTTP
daemon's batcher queue, from its enqueue to the dispatcher taking it into
a group, over the window's requests, from the batcher's counters
(``queue_wait_s`` over ``requests``) in ``Batcher.snapshot()`` before and
after. None where the program keeps no such counter."""


def read(run: dict):
    b, a = run["before"], run["after"]
    if "queue_wait_s" not in b or "queue_wait_s" not in a:
        return None
    requests = a["requests"] - b["requests"]
    if requests <= 0:
        return None
    return 1e3 * (a["queue_wait_s"] - b["queue_wait_s"]) / requests
