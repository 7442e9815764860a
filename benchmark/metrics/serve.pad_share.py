"""serve.pad_share: the share of the images the serving model ran that were
padding (a call's last chunk filled up to its shape bucket), over the
window, from the model's counters (``images_padded`` over ``images_run``)
in ``Batcher.snapshot()`` before and after. None where the program keeps
no such counters."""


def read(run: dict):
    b, a = run["before"], run["after"]
    if "images_run" not in b or "images_run" not in a:
        return None
    ran = a["images_run"] - b["images_run"]
    if ran <= 0:
        return None
    return 100.0 * (a["images_padded"] - b["images_padded"]) / ran
