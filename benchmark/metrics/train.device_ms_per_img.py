"""train.device_ms_per_img: device time per trained image, in ms: the
traced window's busy seconds (the union of device activity under
``torch.profiler``) over the images the window trained. Where the step
waits on the host's launches, ``train_img_per_s`` follows the host's
speed; this leaves the device's waits out, so it moves only with the
work the device does. None where the trace saw no device activity."""


def read(run: dict):
    trace = run["trace"]
    if trace is None or trace["busy_s"] <= 0 or run["images"] <= 0:
        return None
    return 1e3 * trace["busy_s"] / run["images"]
