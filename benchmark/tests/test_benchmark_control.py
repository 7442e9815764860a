"""The controls on the card: the reference in the nearest lower precision
(TF32 for float32 with TF32 off) and the planted faults read above the
limits the cells hold the port to, at a size a test run holds; and every
cell run whole at its own size with the program in TF32 (its own path,
the flags ``run_cell`` sets from the configuration) comes out not correct.

    python -m pytest -p no:cacheprovider -q benchmark/tests    (on the card)
"""

import pytest
import torch

from benchmark import control, run
from benchmark.reference.common import tf32
from benchmark.run import cell_files

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return torch.device("cuda:0")


def test_serving_control_fails():
    device = _card()
    _, _, cfg, traffic = cell_files("csf-r2n50.serve-mixed")
    traffic = {**traffic, "pool": 16}
    got = control.serve_control(cfg, traffic, 2**31 + 3, device)
    assert got["gap_levels"] > traffic["limits"]["gap_levels"], got


def test_training_control_and_faults_fail():
    device = _card()
    _, _, cfg, traffic = cell_files("csnet-l-x2.train-b24")
    traffic = {**traffic, "batch": 8, "resident_batches": 4}
    limits = traffic["limits"]
    got = control.train_control(cfg, traffic, 2**31 + 3, device)
    for case in ("control", "half_batch", "unchanged"):
        assert any(got[case][k] > limits[k] for k in limits), (case, got)


def test_csf_training_control_and_faults_fail():
    device = _card()
    _, _, cfg, traffic = cell_files("csf-r2n50.train-b8")
    traffic = {**traffic, "resident_batches": 30}
    limits = traffic["limits"]
    got = control.train_control(cfg, traffic, 2**31 + 3, device)
    for case in ("control", "half_batch", "unchanged"):
        assert any(got[case][k] > limits[k] for k in limits), (case, got)


@pytest.mark.parametrize("workload", ["csf-r2n50.serve-mixed",
                                      "csnet-l-x2.train-b24",
                                      "csf-r2n50.train-b8"])
def test_a_run_in_tf32_is_not_correct(workload):
    _card()
    with tf32(False):
        line = run.run_cell(workload, 2**31 + 11, 3.0, False, "cuda:0",
                            overrides={"config": {"tf32": True}})
    print(workload, line["checks"])
    assert not line["correct"], line["checks"]
