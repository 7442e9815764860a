"""The headline prune trajectory on synthetic data (the port of
``tools/prune_trajectory.py``).

The reference's claim (CSNet_training/README.md:5): train with the dynamic
weight decay penalty until BN-gamma sparsity develops, prune, and "80% of
parameters reduce with negligible performance drop". This drives the whole
recipe on a synthetic blobby-saliency task, on the resident store: penalty
training (train.py:212-213) -> BN-gamma thresholding (csnet.py:836-853) ->
the channel-gather rebuild -> a BN re-estimation epoch -> a fresh Adam and
a cosine finetune; then prints the params-before/after and val-MAE table.

Usage:
  python -m sod100k_tpu_torch.tools.prune_trajectory [--train-epochs 60]
      [--ft-epochs 15] [--basewidth 16] [--images 96] [--size 64]
      [--batch 16] [--flops-weight 10] [--thres 1e-2] [--json out.json]
      [--device cpu]

The recipe's stages are functions of their own, each taking the
``epochs_of`` it trains with (``recipe_epochs`` over ``resident_epochs``
here): ``penalty_stage``, ``prune_stage`` (keep-alive and prune) and
``recovery_stage`` (re-estimation and finetune).
``tests/test_torch_trajectory.py`` runs the same stages on the JAX
package's draws and holds them to the JAX tool's trajectory.

The JAX package's slow test (tests/test_prune.py::
test_prune_trajectory_end_to_end) holds its run at 600 + 30 epochs,
basewidth 8, 32 images at 48^2, B=8, lr 2e-3, flops weight 30 to >30%
gamma sparsity, >25% parameter drop, post-prune MAE within +0.05 of
pre-prune and a finetuned MAE < 0.15 and <= 1.6x pre-prune
(``INVARIANTS``); ``chip_smoke.py`` holds this port's run to the same
invariants but prints the last, which the JAX package's own runs of that
configuration fail as often as this port's. ``tools.prune_seed_spread``
runs the tool over several seeds at once.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

# the JAX package's slow test of the trajectory (tests/test_prune.py:141-146)
INVARIANTS = {
    "sparsity > 30%": lambda r: r["gamma_sparsity_pct"] > 30,
    "drop > 25%": lambda r: r["param_drop_pct"] > 25,
    "post-prune < pre-prune + 0.05":
        lambda r: r["mae_post_prune"] < r["mae_pre_prune"] + 0.05,
    "finetuned < 0.15": lambda r: r["mae_post_finetune"] < 0.15,
    "finetuned <= 1.6x pre-prune":
        lambda r: r["mae_post_finetune"] <= 1.6 * r["mae_pre_prune"],
}


def failed_invariants(result: dict) -> list[str]:
    """The names of the ``INVARIANTS`` that ``result`` (``run_trajectory``'s
    dict) fails."""
    return [name for name, ok in INVARIANTS.items() if not ok(result)]


def make_synth(n: int, size: int, seed: int = 0):
    """Blobby saliency task: a colored disc on clutter; GT = the disc."""
    rng = np.random.default_rng(seed)
    imgs = np.empty((n, size, size, 3), np.uint8)
    gts = np.empty((n, size, size), np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    m = size // 4
    for i in range(n):
        cy, cx = rng.integers(m, size - m, 2)
        r = rng.integers(size // 8, size // 5)
        blob = ((yy - cy) ** 2 + (xx - cx) ** 2) < r ** 2
        img = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        img[blob] = (200, 60, 60)
        imgs[i] = img
        gts[i] = blob.astype(np.uint8) * 255
    return imgs, gts


def gammas_of(model) -> np.ndarray:
    """The gamma of every branch BN of the ILBlocks and the head (the
    parameters named ``...bns.<j>.weight``), as one f64 array."""
    return np.concatenate([
        p.detach().double().cpu().numpy().ravel()
        for name, p in model.named_parameters()
        if "bns" in name and name.endswith(".weight")])


def keep_one_alive(sd: dict, lc, thres: float) -> int:
    """At demo-scale sparsity the penalty can kill every channel of a
    layer, which no rebuild can represent (``prune`` raises). Lift the
    largest-|gamma| channel of each such layer just over ``thres`` (it is
    dead anyway, and the finetune retrains it). Edits ``sd`` in place;
    returns the count of layers it kept alive."""
    from ..prune.finetune import _collect_gammas, _layer_paths

    kept = 0
    for layer, path in enumerate(_layer_paths(lc)):
        entry = lc.entries[layer]
        g = _collect_gammas(sd, path, entry)
        if np.abs(g).max() >= thres:
            continue
        want = int(np.abs(g).argmax())
        seen = 0
        for j in range(len(entry.out_split)):
            key = (f"{path}.convs.{j}.bn.weight" if path.endswith(".ms")
                   else f"{path}.bns.{j}.weight")
            if key not in sd:
                continue
            width = sd[key].shape[0]
            if want < seen + width:
                v = sd[key][want - seen]
                sd[key][want - seen] = \
                    float(torch.sign(v)) * thres * 1.01 or thres * 1.01
                kept += 1
                break
            seen += width
    return kept


def resident_epochs(rdata: dict, *, batch: int, size: int):
    """The tool's epochs: ``epoch_fn_of(step) -> epoch(seed, lr,
    penalty_on)``, one pass of ``make_resident_epoch_fn`` over the
    resident store ``rdata`` whose permutation and draws come from a
    generator on the store's device seeded with ``seed``."""
    from ..data.resident import make_resident_epoch_fn

    device = rdata["image_u8"].device

    def epoch_fn_of(step):
        epoch_fn = make_resident_epoch_fn(
            step, batch_size=batch, out_hw=(size, size),
            max_crop=max_crop_of(size))

        def epoch(seed: int, lr: float, penalty_on: float):
            gen = torch.Generator(device).manual_seed(seed)
            return epoch_fn(rdata, gen, lr, penalty_on)

        return epoch

    return epoch_fn_of


def max_crop_of(size: int) -> int:
    """The crop margin at the store size: the reference's 15 px at 224."""
    return max(1, round(15 * size / 224))


def recipe_epochs(epoch_fn_of, *, batch: int):
    """``epochs_of(model, optimizer, flops_weight) -> epoch(seed, lr,
    penalty_on)``: the recipe's train step of ``model`` (the penalty's
    flop weights at expand 1.0, divided by ``batch``), run by
    ``epoch_fn_of`` (``resident_epochs``' or a caller's)."""
    from ..train.step import make_train_step

    def epochs_of(model, optimizer, flops_weight: float):
        return epoch_fn_of(make_train_step(
            model, optimizer, flops_weight=flops_weight, flops_expand=1.0,
            batch_size=batch))

    return epochs_of


def penalty_stage(model, epochs_of, *, train_epochs: int, lr: float,
                  flops_weight: float, weight_decay: float, thres: float,
                  seed: int, log=print, on_epoch=None) -> None:
    """Penalty training: Adam with dynamic weight decay, the penalty on,
    epoch e drawn from seed * 7_777_777 + e. ``on_epoch(e, losses,
    penalties)`` sees every epoch."""
    from ..train.optim import make_adam_dwd

    epoch = epochs_of(model, make_adam_dwd(model, weight_decay=weight_decay),
                      flops_weight)
    for e in range(train_epochs):
        losses, pens = epoch(seed * 7_777_777 + e, lr, 1.0)
        if on_epoch is not None:
            on_epoch(e, losses, pens)
        if (e + 1) % max(train_epochs // 6, 1) == 0:
            sp = float((np.abs(gammas_of(model)) < thres).mean())
            log(f"  epoch {e + 1}: loss {float(losses[-1]):.4f} "
                f"penalty {float(pens[-1]):.4f} "
                f"gamma sparsity(|g|<{thres:g}) {sp * 100:.0f}%")


def prune_stage(model, thres: float, *, log=print):
    """Keep-alive and prune of the trained ``model``: returns (the slim
    CSNet on the model's device, its masks, the count of layers kept
    alive)."""
    from ..prune.finetune import build_pruned_csnet, prune

    pre = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    kept_alive = keep_one_alive(pre, model.lc, thres)
    if kept_alive:
        log(f"kept 1 channel alive in {kept_alive} fully-dead block(s)")
    slim_sd, slim_lc, masks = prune(pre, model.lc, thres)
    device = next(model.parameters()).device
    return build_pruned_csnet(slim_lc, slim_sd, device=device), masks, \
        kept_alive


def recovery_stage(slim, epochs_of, *, ft_epochs: int, lr: float, seed: int,
                   val_mae, log=print, on_epoch=None) -> tuple[float, float]:
    """BN re-estimation, then the cosine finetune of the slim model.
    Returns (val MAE after the re-estimation, after the finetune);
    ``val_mae(model) -> float``. ``on_epoch(e, losses, penalties)`` sees
    the re-estimation epoch as e = -1, then every finetune epoch."""
    from ..train.optim import make_adam

    # prune() resets the BN running statistics to (0, 1), as the
    # reference's load_BN_weight does; score the slim model after one
    # zero-lr epoch re-estimates them (Adam at lr 0 leaves the weights,
    # the train-mode forward moves the statistics): what pruning alone
    # costs, before any recovery
    epoch = epochs_of(slim, make_adam(slim), 0.0)
    losses, pens = epoch(seed * 7_777_779, 0.0, 0.0)
    if on_epoch is not None:
        on_epoch(-1, losses, pens)
    mae_pruned = val_mae(slim)

    # the re-estimation epoch's gradients met unconverged statistics: the
    # recovery starts from fresh Adam moments, at a cosine-annealed lr
    # (the reference finetune's CosineAnnealingLR)
    epoch = epochs_of(slim, make_adam(slim), 0.0)
    for e in range(ft_epochs):
        ft_lr = 0.5 * (lr / 2) * (1 + math.cos(math.pi * e / ft_epochs))
        losses, pens = epoch(seed * 7_777_771 + e, ft_lr, 0.0)
        if on_epoch is not None:
            on_epoch(e, losses, pens)
    if ft_epochs:
        log(f"  finetune final train loss {float(losses[-1]):.4f}")
    return mae_pruned, val_mae(slim)


def run_trajectory(*, train_epochs: int = 60, ft_epochs: int = 15,
                   basewidth: int = 16, images: int = 96, size: int = 64,
                   batch: int = 16, lr: float = 1e-3,
                   flops_weight: float = 10.0, weight_decay: float = 5e-3,
                   thres: float = 1e-2, seed: int = 0, log=print,
                   device: str | torch.device = "cuda") -> dict:
    from ..arch.csnet import CSNet, count_params
    from ..arch.layer_config import init_layers
    from ..data.pipeline import require_device
    from ..train.step import make_eval_step

    device = require_device(device)
    imgs, gts = make_synth(images, size, seed)
    vimgs, vgts = make_synth(max(images // 4, batch), size, seed + 1)
    rdata = {"image_u8": torch.from_numpy(imgs).to(device),
             "gt_u8": torch.from_numpy(gts).to(device)}
    vx = torch.from_numpy(vimgs).to(device)
    vt = torch.from_numpy(vgts).to(device).float()[..., None] / 255.0
    epochs_of = recipe_epochs(resident_epochs(rdata, batch=batch, size=size),
                              batch=batch)

    def val_mae(model) -> float:
        pred = make_eval_step(model, from_u8=True)(vx)
        return float(torch.mean(torch.abs(pred - vt)))

    model = CSNet(init_layers(basewidth, [0.5, 0.5]), seed=seed,
                  device=device)
    params_before = count_params(model)
    log(f"train: {train_epochs} epochs, dynamic-wd penalty weight "
        f"{flops_weight}, {images} imgs @{size}px, batch {batch}")
    penalty_stage(model, epochs_of, train_epochs=train_epochs, lr=lr,
                  flops_weight=flops_weight, weight_decay=weight_decay,
                  thres=thres, seed=seed, log=log)
    mae_pre = val_mae(model)
    gamma_sparsity = float((np.abs(gammas_of(model)) < thres).mean())

    slim, _, _ = prune_stage(model, thres, log=log)
    params_after = count_params(slim)
    mae_pruned, mae_ft = recovery_stage(
        slim, epochs_of, ft_epochs=ft_epochs, lr=lr, seed=seed,
        val_mae=val_mae, log=log)

    drop = 1.0 - params_after / params_before
    # an all-zero predictor scores MAE = the GT foreground fraction; a
    # demo MAE means something only below it
    mae_trivial = float(torch.mean(vt))
    result = {
        "mae_trivial_all_zero": round(mae_trivial, 5),
        "params_before": int(params_before),
        "params_after": int(params_after),
        "param_drop_pct": round(drop * 100, 1),
        "gamma_sparsity_pct": round(gamma_sparsity * 100, 1),
        "mae_pre_prune": round(mae_pre, 5),
        "mae_post_prune": round(mae_pruned, 5),
        "mae_post_finetune": round(mae_ft, 5),
        "train_epochs": train_epochs, "ft_epochs": ft_epochs,
        "thres": thres, "flops_weight": flops_weight,
        "basewidth": basewidth, "images": images, "size": size,
    }
    log(f"(all-zero-predictor baseline MAE: {mae_trivial:.5f})")
    log("| stage | params | val MAE |")
    log("|---|---|---|")
    log(f"| trained (dynamic wd) | {params_before:,} | {mae_pre:.5f} |")
    log(f"| pruned @|gamma|<{thres:g} | {params_after:,} "
        f"(-{drop * 100:.1f}%) | {mae_pruned:.5f} |")
    log(f"| finetuned | {params_after:,} | {mae_ft:.5f} |")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train-epochs", type=int, default=60)
    ap.add_argument("--ft-epochs", type=int, default=15)
    ap.add_argument("--basewidth", type=int, default=16)
    ap.add_argument("--images", type=int, default=96)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--flops-weight", type=float, default=10.0)
    ap.add_argument("--weight-decay", type=float, default=5e-3)
    ap.add_argument("--thres", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = run_trajectory(
        train_epochs=args.train_epochs, ft_epochs=args.ft_epochs,
        basewidth=args.basewidth, images=args.images, size=args.size,
        batch=args.batch, lr=args.lr, flops_weight=args.flops_weight,
        weight_decay=args.weight_decay, thres=args.thres, seed=args.seed,
        device=args.device)
    print(json.dumps(res))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
