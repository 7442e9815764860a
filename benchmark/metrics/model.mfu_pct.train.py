"""model.mfu_pct.train: the train step's share of the card's peak for the
configuration's precision: images over the window times 3 x the forward's
FLOPs (forward + backward counted as three forwards), over the window."""


def read(run: dict):
    if run["window_s"] <= 0:
        return None
    return (100.0 * run["images"] * 3.0 * run["flops_per_img"]
            / run["window_s"] / run["peak_flops"])
