"""``tools.bench_extras`` on the CPU: every entry runs small (CSNet at
width 8, 32 px; CSF+Res2Net at full width and 32 px; a few images) and
names its rows as ``tools/bench_extras.py`` does.

The names are the JAX tool's text, taken from its file by line (the table
below; ``test_the_table_is_the_jax_tools`` holds each line), filled with
the run's values where the JAX line is an f-string. The times are the
CPU's and mean nothing here.
"""

from __future__ import annotations

import json
import math
import os

import pytest
import torch

from sod100k_tpu_torch.arch.layer_config import init_layers
from sod100k_tpu_torch.tools import bench_extras as be

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tools/bench_extras.py: line -> the metric's text there (an f-string's
# text is a format template of the same names)
JAX = {
    117: "csnet_l_x2_224_infer_latency_ms[bf16,B=1]",
    130: "csf_res2net50_336_infer_latency_ms[bf16,B=1]",
    142: "csf_res2net50_336_infer_img_per_sec[bf16,B=32]",
    154: "csf_res2net101_336_infer_img_per_sec[bf16,B=32]",
    206: "csnet_l_x2_224_serving_artifact_img_per_sec[bf16,B=128]",
    251: "csnet_l_x2_224_train_step_img_per_sec[{dtype_name},B={batch_size}]",
    300: "csf_{arch}_336_train_microstep_ms{suffix}",
    347: "csf_res2net50_336_resident_train_img_per_sec[bf16,B={batch_size}]",
    396: "csnet_l_x2_resident_val_img_per_sec[bf16,B={batch},n={n}]",
    447: "csnet_l_x2_resident_testall_img_per_sec[bf16,B={batch},n={n}]",
    495: "csnet_l_x2_224_e2e_train_img_per_sec[{mode}_preprocess{tag},"
         "B={bsz}]",
    536: "csnet_l_x2_224_e2e_test_img_per_sec[{mode}_preprocess,bf16,B=128]",
    565: "csnet_l_x2_native320_e2e_test_img_per_sec[test_batch={tb},bf16]",
    617: "csf_res2net50_336_e2e_test_fps[bf16,test_batch={tb}]",
}


def test_the_table_is_the_jax_tools():
    with open(os.path.join(REPO, "tools", "bench_extras.py")) as f:
        lines = f.read().splitlines()
    for line, text in JAX.items():
        if line == 565:  # one f-string over two lines
            assert 'f"csnet_l_x2_native320_e2e_test_img_per_sec"' in \
                lines[564]
            assert 'f"[test_batch={tb},bf16]"' in lines[565]
            continue
        assert f'"{text}"' in lines[line - 1], (line, lines[line - 1])


def _csf_suffix(dtype_name: str, batch_size: int) -> str:
    """tools/bench_extras.py:297-298."""
    return f"[B={batch_size}]" if dtype_name == "f32" \
        else f"[{dtype_name},B={batch_size}]"


def _e2e_tag(dtype: str) -> str:
    """tools/bench_extras.py:491."""
    return "" if dtype == "float32" else ",bf16"


STEP_PLANS = ((4, "f32"), (2, "f32"), (4, "bf16"))
CSF_PLANS = (("res2net50", ((1, "f32"), (2, "f32"), (2, "bf16"),
                            (4, "bf16"))),
             ("res2net101", ((2, "bf16"),)))
E2E_TRAIN = (("hybrid", "float32", 4), ("device", "float32", 4),
             ("host", "float32", 4), ("resident", "float32", 4),
             ("hybrid", "bfloat16", 8), ("device", "bfloat16", 8),
             ("resident", "bfloat16", 8))


def _small(tmp_path) -> dict:
    """Each entry's small run: (function, args, kwargs, the names it must
    give, in order)."""
    lc = str(tmp_path / "lc8.bin")
    init_layers(8, [0.5, 0.5]).save(lc)
    data = str(tmp_path / "data")
    return {
        "serving": (be.bench_serving_artifact, (), dict(
            batch=2, hw=32, width=8, k=2), [JAX[206]]),
        "latency": (be.bench_inference_latency, (), dict(
            hw=32, csf_hw=32, width=8, csf_batch=2, k=2, k_csf=2,
            k_batch=2), [JAX[117], JAX[130], JAX[142], JAX[154]]),
        "csnet_steps": (be.bench_csnet_train_steps, (), dict(
            hw=32, width=8, k=1, plans=STEP_PLANS),
            [JAX[251].format(dtype_name=d, batch_size=b)
             for b, d in STEP_PLANS]),
        "csf_steps": (be.bench_csf_steps, (), dict(
            hw=32, k=1, plans=CSF_PLANS),
            [JAX[300].format(arch=a, suffix=_csf_suffix(d, b))
             for a, combos in CSF_PLANS for b, d in combos]),
        "csf_resident": (be.bench_csf_resident_epoch, (), dict(
            n=4, batch_size=2, hw=32, k=1),
            [JAX[347].format(batch_size=2)]),
        "val": (be.bench_resident_val, (), dict(
            n=8, batch=4, hw=32, width=8, native_hw=(30, 40)),
            [JAX[396].format(batch=4, n=8)]),
        "testall": (be.bench_resident_testall, (), dict(
            n=8, batch=4, hw=32, width=8, native_hw=(30, 40)),
            [JAX[447].format(batch=4, n=8)]),
        "e2e_train": (be.bench_e2e_train, (data,), dict(
            n=8, native_hw=(64, 48), image_hw=32, configs=E2E_TRAIN,
            predefine=lc, store_hw=48),
            [JAX[495].format(mode=m, tag=_e2e_tag(d), bsz=b)
             for m, d, b in E2E_TRAIN]),
        "e2e_test": (be.bench_e2e_test, (data,), dict(
            n=8, native_hw=(40, 30), image_hw=32, batch=4, width=8,
            native_n=4, uniform_hw=32, test_batches=(1, 2)),
            [JAX[536].format(mode=m) for m in ("hybrid", "device", "host")]
            + [JAX[565].format(tb=tb) for tb in (1, 2)]),
        "csf_e2e_test": (be.bench_csf_e2e_test, (data,), dict(
            n=4, hw=32, test_batches=(1, 2)),
            [JAX[617].format(tb=tb) for tb in (1, 2)]),
    }


@pytest.mark.parametrize("entry", [
    "serving", "latency", "csnet_steps", "csf_steps", "csf_resident", "val",
    "testall", "e2e_train", "e2e_test", "csf_e2e_test"])
def test_entry_runs_small_and_names_its_rows_as_the_jax_tool(entry,
                                                             tmp_path):
    fn, args, kwargs, names = _small(tmp_path)[entry]
    entries: list = []
    fn(entries, *args, device=CPU, **kwargs)
    assert [e["metric"] for e in entries] == names
    for e in entries:
        assert math.isfinite(e["value"]) and e["value"] > 0, e
        assert e["unit"] == ("ms" if "_ms" in e["metric"] else "images/sec")
        assert e["hw"] == 32
        if "peak_mem_gib" in e:
            assert e["peak_mem_gib"] is None  # no card, no card memory
    seeded = {"serving", "latency", "e2e_test", "csf_e2e_test"}
    if entry in seeded:
        assert any(e.get("weights") == "seeded" for e in entries)


def test_the_flags_keep_the_jax_tools_entries_and_order(monkeypatch):
    """Every --skip-* flag of the JAX tool (tools/bench_extras.py:623-630)
    and the entries in its main's order (:635-652)."""
    calls = []
    for name in ("bench_serving_artifact", "bench_inference_latency",
                 "bench_csnet_train_steps", "bench_csf_steps",
                 "bench_csf_resident_epoch", "bench_resident_val",
                 "bench_resident_testall", "bench_e2e_train",
                 "bench_e2e_test", "bench_csf_e2e_test"):
        monkeypatch.setattr(be, name, lambda *a, _n=name, **k:
                            calls.append(_n))
    parser = be.build_parser()
    be.run_entries(parser.parse_args([]), CPU)
    assert calls == ["bench_serving_artifact", "bench_inference_latency",
                     "bench_csnet_train_steps", "bench_csf_steps",
                     "bench_csf_resident_epoch", "bench_resident_val",
                     "bench_resident_testall", "bench_e2e_train",
                     "bench_e2e_test", "bench_csf_e2e_test"]
    calls.clear()
    be.run_entries(parser.parse_args(["--skip-e2e"]), CPU)
    assert calls[-1] == "bench_resident_testall" and len(calls) == 7
    calls.clear()
    be.run_entries(parser.parse_args(
        ["--skip-serving", "--skip-latency", "--skip-step", "--skip-csf",
         "--skip-val", "--skip-e2e-test"]), CPU)
    assert calls == ["bench_e2e_train"]
    calls.clear()
    be.run_entries(parser.parse_args(["--skip-e2e-train", "--skip-e2e-test",
                                      "--skip-serving", "--skip-latency",
                                      "--skip-step", "--skip-csf",
                                      "--skip-val"]), CPU)
    assert calls == []


def test_merge_keeps_one_cards_rows(tmp_path, capsys):
    out = tmp_path / "extras.json"
    card = {"device": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    be.merge_into(str(out), [{"metric": "a", "value": 1.0},
                             {"metric": "b", "value": 2.0}], card)
    got = be.merge_into(str(out), [{"metric": "b", "value": 3.0}], card)
    assert got == {**card, "entries": [{"metric": "a", "value": 1.0},
                                       {"metric": "b", "value": 3.0}]}
    assert json.loads(out.read_text()) == got
    other = {**card, "power_limit": "500.00 W"}
    got = be.merge_into(str(out), [{"metric": "c", "value": 4.0}], other)
    assert got == {**other, "entries": [{"metric": "c", "value": 4.0}]}
    assert "replaced" in capsys.readouterr().err


def test_main_writes_its_own_file_never_the_jax_tools(monkeypatch,
                                                      tmp_path, capsys):
    assert be.OUT == os.path.join(REPO, "sod100k_tpu_torch", "tools",
                                  "bench_extras.json")
    monkeypatch.setattr(be, "bench_resident_val", lambda entries, **k:
                        entries.append({"metric": "v", "value": 1.0}))
    out = tmp_path / "e.json"
    skips = ["--skip-serving", "--skip-latency", "--skip-step", "--skip-csf",
             "--skip-e2e"]
    monkeypatch.setattr(be, "bench_resident_testall", lambda entries, **k:
                        None)
    entries = be.main(skips + ["--out", str(out), "--device", "cpu"])
    assert entries == [{"metric": "v", "value": 1.0}]
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == entries
    assert json.loads(out.read_text())["device"] == "cpu"
