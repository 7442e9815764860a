"""The counts the configuration files hold, counted again: FLOPs per
image from the reference, the fused tail's bytes against the shapes of
the port's own launches in a CSNet-L-x2 forward."""

import json
import os

import pytest
import torch

from benchmark import counts, roofline

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")


def _cfg(name):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["csnet-l-x2", "csf-r2n50"])
def test_config_counts_are_current(name):
    cfg = _cfg(name)
    got = counts.count(cfg)
    assert got["flops_per_img"] == cfg["flops_per_img"]
    if cfg["family"] == "csnet":
        assert got["dw_chain"] == cfg["dw_chain"]


def test_flops_agree_with_the_ports_counter():
    from sod100k_tpu_torch.arch.csnet import CSNet
    from sod100k_tpu_torch.arch.layer_config import init_layers
    from sod100k_tpu_torch.utils.profiler import simplesum

    cfg = _cfg("csnet-l-x2")
    model = CSNet(init_layers(cfg["basewidth"], cfg["split"]), device="cpu")
    params, flops = simplesum(model, (cfg["hw"], cfg["hw"], 3))
    assert params == cfg["parameters"]
    assert flops == cfg["flops_per_img"]


def test_tail_bytes_match_the_ports_launches(monkeypatch):
    from sod100k_tpu_torch.arch.csnet import CSNet
    from sod100k_tpu_torch.arch.layer_config import init_layers
    from sod100k_tpu_torch.ops import dw_chain

    cfg = _cfg("csnet-l-x2")
    shapes = []
    plain = dw_chain.fused_dw_chain_packed

    def record(x, packed):
        shapes.append(tuple(x.shape[1:]))
        return plain(x, packed)

    monkeypatch.setattr(dw_chain, "fused_dw_chain_packed", record)
    model = CSNet(init_layers(cfg["basewidth"], cfg["split"]),
                  device="cpu").eval()
    with torch.no_grad():
        model(torch.zeros((1, cfg["hw"], cfg["hw"], 3)))
    assert len(shapes) == cfg["dw_chain"]["launches_per_forward"] == 33
    assert roofline.dw_chain_work(shapes) == cfg["dw_chain"]


def test_roofline_arithmetic():
    assert roofline.buckets_of(1, [1, 8, 32, 128]) == [1]
    assert roofline.buckets_of(9, [1, 8, 32, 128]) == [32]
    assert roofline.buckets_of(300, [1, 8, 32, 128]) == [128, 128, 128]
    assert roofline.buckets_of(130, [1, 8, 32, 128]) == [128, 8]
    work = _cfg("csnet-l-x2")["dw_chain"]
    # bf16 B=32 would be 0.3948 ms; f32 doubles the bytes
    t = roofline.dw_chain_bound_s(work, [32], roofline.PEAK_FLOPS["float32"])
    assert t == pytest.approx((32 * work["bytes_per_img"]
                               + work["param_bytes"]) / 3.35e12)
    assert 0.78e-3 < t < 0.8e-3
