"""serve.batch_img: images per device dispatch of the HTTP daemon's
batcher over the window, from ``Batcher.snapshot()`` before and after."""


def read(run: dict):
    b, a = run["before"], run["after"]
    dispatches = a["dispatches"] - b["dispatches"]
    if dispatches <= 0:
        return None
    return (a["images"] - b["images"]) / dispatches
