"""The plain reference against the port, at small sizes on the CPU: the
parameter spec against the port's state dict, both forwards, and the
train steps' losses, first gradients and updates."""

import pytest
import torch

from benchmark import check, families, weights
from benchmark.reference.common import Norms
from benchmark.train_cell import _Program, _reference, make_batches

SEED = 2**31 + 77


def _setup(cfg, hw, n=2):
    fam = families.family(cfg)
    state = weights.seeded_state(fam.spec(), SEED, "cpu")
    images = torch.randint(0, 256, (n, hw, hw, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3))
    weights.calibrate(fam, state, images)
    return fam, state, images


@pytest.mark.parametrize("cfg,hw", [
    ({"family": "csnet", "basewidth": 8, "split": [0.5, 0.5]}, 32),
    ({"family": "csnet", "basewidth": 40, "split": [0.5, 0.5]}, 32),
    ({"family": "csnet", "basewidth": 8, "split": [1.0]}, 32),
    ({"family": "csf", "backbone": "res2net50"}, 64),
], ids=["csnet-w8", "csnet-l-x2", "csnet-w8-x1", "csf-r2n50"])
def test_eval_forward_matches_the_port(cfg, hw):
    from sod100k_tpu_torch.train.step import make_eval_step

    fam, state, images = _setup(cfg, hw)
    model = fam.program_model(state, "cpu")
    ours = model.state_dict()
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in state.items()}
    got = make_eval_step(model, from_u8=True)(images)
    with torch.no_grad():
        want = torch.sigmoid(fam.forward(state, images)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    # f32 on the CPU: other convolution algorithms, a few ulps per layer
    assert (got - want).abs().max().item() < 1e-4
    assert want.std().item() > 1e-2  # the calibrated maps are not flat


def test_calibration_sets_running_statistics():
    fam, state, images = _setup({"family": "csnet", "basewidth": 8,
                                 "split": [0.5, 0.5]}, 32)
    norms = Norms("calibrate")
    with torch.no_grad():
        fam.forward(state, images, norms)
    # every BN of the net is met and holds its batch's statistics
    bns = {n.rsplit(".", 1)[0] for n, _, k in fam.spec() if k == "mean"}
    assert set(norms.stats) == bns
    for name, (mean, var) in norms.stats.items():
        assert torch.allclose(state[name + ".running_mean"], mean, atol=1e-5)
        assert torch.allclose(state[name + ".running_var"], var, rtol=1e-4)


@pytest.mark.parametrize("cfg,traffic,hw,bars", [
    # f32 on the CPU. CSNet: two Adam steps move each element by about lr
    # whatever its gradient's size, so a sign flip of a near-zero gradient
    # element moves a small leaf's change (0.18 read at this size); CSF:
    # the backbone's sum-loss gradients cancel, and one f32 engine against
    # another reads 3.6% on a conv weight's norm (1.5e-4 in float64)
    ({"family": "csnet", "basewidth": 8, "split": [0.5, 0.5]},
     {"batch": 4, "lr": 1e-3, "penalty_weight": 3.0, "penalty_expand": 2.0,
      "weight_decay": 5e-3, "resident_batches": 4}, 32,
     {"loss_gap": 1e-5, "grad_gap": 1e-2, "change_gap": 0.5}),
    ({"family": "csf", "backbone": "res2net50"},
     {"batch": 1, "iter_size": 2, "lr": 5e-5, "weight_decay": 5e-4,
      "resident_batches": 4}, 64,
     {"loss_gap": 1e-5, "grad_gap": 0.1, "change_gap": 1e-3}),
], ids=["csnet", "csf"])
def test_train_steps_match_the_port(cfg, traffic, hw, bars):
    steps = 2 if cfg["family"] == "csnet" else 1
    fam = families.family(cfg)
    state = weights.seeded_state(fam.spec(), SEED, "cpu")
    images, targets = make_batches(SEED, traffic["resident_batches"],
                                   traffic["batch"], hw, "cpu")
    weights.calibrate(fam, state, images[0])
    prog = _Program(fam, cfg, traffic, state, "cpu")
    p0 = prog.params()
    losses, k = [], 0
    for s in range(steps):
        total = 0.0
        for _ in range(prog.micro):
            total += float(prog(images[k], targets[k]))
            k += 1
        losses.append(total)
        if s == 0:
            grad = prog.first_moments()
    readings = {"losses": losses, "grad": grad,
                "change": {n: v - p0[n] for n, v in prog.params().items()}}
    ref = _reference(fam, cfg, traffic, state, images, targets, steps)
    assert set(readings["grad"]) == set(ref["grad"])
    n = check.train_numbers(readings, ref)
    assert all(n[k] < bars[k] for k in bars), n
