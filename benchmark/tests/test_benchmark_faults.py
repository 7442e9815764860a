"""The harness without its look for a card: a whole run on the CPU at a
tiny size, sound and with the timed path broken underneath, where
``correct`` has to come out false: a served answer altered where it is
produced; a train step that leaves its state unchanged; a train step that
sees half of each batch, the mean taken over the rest."""

import pytest
import torch

from benchmark import run

SEED = 2**31 + 4242
SERVE = {"config": {"hw": 64, "buckets": [1, 4]},
         "traffic": {"rate_img_s": 24, "pool": 8}}
TRAIN = {"config": {"basewidth": 8, "hw": 32},
         "traffic": {"batch": 4, "resident_batches": 5}}


def _serve():
    return run.run_cell("csf-r2n50.serve-mixed", SEED, 1.5, False, "cpu",
                        overrides=SERVE)


def test_sound_serving_run_is_correct():
    line = _serve()
    assert line["correct"], line["checks"]
    assert line["attempted"] > 10 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "serve_p50_ms"}


def test_an_altered_answer_is_caught(monkeypatch):
    from sod100k_tpu_torch import serve

    forward = serve.ServingModel._forward

    def altered(self, chunk):
        out = forward(self, chunk).copy()
        out[-1, :4, :4] = 255 - out[-1, :4, :4]
        return out

    monkeypatch.setattr(serve.ServingModel, "_forward", altered)
    line = _serve()
    assert not line["correct"]
    assert line["checks"]["gap_levels"]["value"] > 10


def _train():
    return run.run_cell("csnet-l-x2.train-b24", SEED, 1.0, False, "cpu",
                        overrides=TRAIN)


def test_train_faults_are_caught(monkeypatch):
    sound = _train()["checks"]
    from sod100k_tpu_torch.train import step as tstep

    make = tstep.make_train_step

    def half_batch(model, optimizer, **kw):
        inner = make(model, optimizer, **kw)

        def step(batch, lr, penalty_on):
            n = batch["image"].shape[0] // 2
            return inner({k: v[:n] for k, v in batch.items()}, lr,
                         penalty_on)
        return step

    with monkeypatch.context() as m:
        m.setattr(tstep, "make_train_step", half_batch)
        half = _train()
    assert not half["correct"]
    with monkeypatch.context() as m:
        m.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
        unchanged = _train()
    assert not unchanged["correct"]
    assert unchanged["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    # the sound run reads far below both faults on some number
    for fault in (half["checks"], unchanged["checks"]):
        assert any(fault[k]["value"] > 10 * sound[k]["value"]
                   and fault[k]["value"] > fault[k]["limit"] for k in fault)
