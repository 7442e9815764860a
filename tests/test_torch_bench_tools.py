"""The port's measurement tools on the CPU: ``tools.bench``,
``tools.bench_serve`` and ``tools.bench_check`` against the JAX tools
(``bench.py``, ``tools/bench_serve.py``, ``tools/bench_check.py``) at
width 8 and 32 px.

The JAX tools' row keys and guard tables are read from their files (by
line where a table quotes them); ``tools/bench_check.py`` imports no jax,
so it loads by path and its verdicts are compared case by case. The numbers
the tools time here are the CPU's and mean nothing; the tests hold the
rows' shapes, the gates and the refusals.
"""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from sod100k_tpu_torch.tools import (bench, bench_check, bench_serve,
                                     timing)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_lines(rel: str) -> list[str]:
    with open(os.path.join(REPO, rel)) as f:
        return f.read().splitlines()


@pytest.fixture
def small_bench(monkeypatch):
    for name, value in (("WIDTH", 8), ("HW", 32), ("BATCH", 2),
                        ("SCAN_LEN", 2)):
        monkeypatch.setattr(bench, name, value)


# bench.py:121-126, the row main() prints
JAX_BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]


def test_bench_prints_one_json_line_with_the_jax_keys(small_bench, capsys):
    lines = _jax_lines("bench.py")
    row_text = "\n".join(lines[120:126])
    for key in JAX_BENCH_KEYS:
        assert f'"{key}":' in row_text
    assert ('f"csnet_l_x2_224_inference_images_per_sec_per_chip[{name}]"'
            in row_text)

    bench.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    row = json.loads(out[0])
    assert list(row)[:4] == JAX_BENCH_KEYS
    # f32 on the CPU is the plain tail itself: MAE 0, so the gate passes
    assert row["metric"] in (
        "csnet_l_x2_224_inference_images_per_sec_per_chip[bf16]",
        "csnet_l_x2_224_inference_images_per_sec_per_chip[f32]")
    assert row["unit"] == "images/sec" and row["value"] > 0
    # both rounded from the unrounded rate
    assert abs(row["vs_baseline"] - row["value"] / 2.9) <= 0.1
    assert row["device"] == "cpu" and row["power_limit"] is None
    assert row["weights"] == "seeded"


def test_bench_refuses_a_model_that_differs_from_its_reference(
        small_bench, monkeypatch, capsys):
    """One tail weight moved after the reference map is taken: neither
    dtype passes its bar, the tool exits non-zero and prints no row."""
    reference = bench.reference_maps

    def then_perturb(model, x, shipped):
        want = reference(model, x, shipped)
        with torch.no_grad():
            model.stage1[0].conv3x3_1.convs["0"].weight.add_(0.05)
        return want

    monkeypatch.setattr(bench, "reference_maps", then_perturb)
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu"])
    assert e.value.code not in (0, None)
    assert "parity gate failed" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_bench_reference_is_the_plain_tail_in_f32(small_bench):
    """The seeded reference: the same model with ``fused_dw_chain_ref`` in
    each ILBlock, f32; on the CPU the model's own tail is that function,
    so the two agree to the last bit, and a twin with the tail dropped
    does not."""
    model, weights = bench.load_model("", "cpu")
    assert weights == "seeded" and not model.training
    x = torch.from_numpy(bench.golden_input())
    want = bench.reference_maps(model, x, shipped=False)
    assert want.shape == (2, 32, 32)
    assert bench.parity_mae(model, x, want, torch.float32) == 0.0
    dropped = bench.with_tail(model, lambda block, y: y)
    assert bench.parity_mae(dropped, x, want, torch.float32) > 1e-3


def test_chain_feeds_each_call_the_last_output():
    seen = []

    def fn(x):
        seen.append(x.clone())
        return x + 1.0

    x0 = torch.zeros(2, 3)
    ms = timing.chain_ms(fn, x0, k=3, repeats=2)
    assert ms >= 0.0
    assert len(seen) == 1 + 2 * 3  # one warm-up, then two chains of three
    for a, b in zip(seen, seen[1:]):
        step = float(b[0, 0] - a[0, 0])
        assert step == pytest.approx((a[0, 0].item() + 1.0) * 1e-6, rel=1e-3)


# tools/bench_serve.py:153-161, the row's keys; "platform" becomes the
# card's name and power limit, and the client threads' encode time joins
JAX_SERVE_KEYS = ["direct_img_per_sec", "served_img_per_sec",
                  "served_over_direct", "clients", "req_batch", "dispatches",
                  "mean_dispatch_batch", "hw", "buckets", "wire", "dtype",
                  "platform"]
SERVE_ARGS = ["--device", "cpu", "--hw", "32", "--width", "8", "--buckets",
              "2,4", "--clients", "2", "--req-batch", "2", "--secs", "1"]


def test_bench_serve_row_has_the_jax_keys(capsys, tmp_path):
    text = "\n".join(_jax_lines("tools/bench_serve.py")[152:161])
    for key in JAX_SERVE_KEYS:
        assert f'"{key}":' in text
    out = tmp_path / "serve.json"
    row = bench_serve.main(SERVE_ARGS + ["--json", str(out)])
    want = [k for k in JAX_SERVE_KEYS if k != "platform"]
    want.insert(want.index("hw"), "client_encode_ms")
    assert list(row) == want + ["device", "power_limit"]
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == row
    assert json.loads(out.read_text()) == row
    assert row["served_img_per_sec"] > 0 and row["direct_img_per_sec"] > 0
    assert row["dispatches"] > 0 and row["device"] == "cpu"
    assert row["buckets"] == [2, 4]


def test_bench_serve_exits_1_on_a_wrong_size_response(monkeypatch):
    post = bench_serve._post_npy
    monkeypatch.setattr(bench_serve, "_post_npy",
                        lambda url, body: post(url, body)[:-1])
    with pytest.raises(SystemExit) as e:
        bench_serve.main(SERVE_ARGS)
    assert e.value.code == 1


def _jax_bench_check():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_check", os.path.join(REPO, "tools", "bench_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_check_tables_are_the_jax_tools():
    jax_check = _jax_bench_check()
    assert bench_check.GUARDED_EXTRAS == jax_check.GUARDED_EXTRAS
    assert bench_check.LOWER_IS_BETTER == jax_check.LOWER_IS_BETTER


@pytest.mark.parametrize("metric,fresh,ref,tol", [
    ("csnet_l_x2_224_train_step_img_per_sec[f32,B=128]", 100.0, 100.0, 0.15),
    ("csnet_l_x2_224_train_step_img_per_sec[f32,B=128]", 85.0, 100.0, 0.15),
    ("csnet_l_x2_224_train_step_img_per_sec[f32,B=128]", 84.9, 100.0, 0.15),
    ("csnet_l_x2_224_train_step_img_per_sec[f32,B=128]", 150.0, 100.0, 0.15),
    ("csnet_l_x2_224_infer_latency_ms[bf16,B=1]", 1.15, 1.0, 0.15),
    ("csnet_l_x2_224_infer_latency_ms[bf16,B=1]", 1.151, 1.0, 0.15),
    ("csnet_l_x2_224_infer_latency_ms[bf16,B=1]", 0.5, 1.0, 0.15),
    ("csf_res2net50_336_train_microstep_ms[bf16,B=8]", 30.0, 20.0, 0.15),
    ("csf_res2net50_336_train_microstep_ms[bf16,B=8]", 18.0, 20.0, 0.15),
    ("some_row_ms[x]", 2.0, 1.0, 0.5),
    ("csf_res2net50_336_infer_img_per_sec[bf16,B=32]", 50.0, 100.0, 0.6),
    ("csnet_l_x2_224_inference_images_per_sec_per_chip[bf16]", 1.0, 2.0,
     0.0),
])
def test_bench_check_verdicts_are_the_jax_tools(metric, fresh, ref, tol):
    jax_check = _jax_bench_check()
    assert bench_check.lower_is_better(metric) == \
        jax_check.lower_is_better(metric)
    assert bench_check.compare(metric, fresh, ref, tol) == \
        jax_check.compare(metric, fresh, ref, tol)


@pytest.mark.parametrize("argv", [[], ["--record"], ["--extras"],
                                  ["--force"]])
def test_bench_check_refuses_without_a_card(argv, tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit) as e:
        bench_check.main(argv + ["--reference", str(tmp_path / "r.json")])
    assert e.value.code not in (0, None)
    assert "no CUDA device" in str(e.value.code)
    assert not (tmp_path / "r.json").exists()


CARD = {"device": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
HEADLINE = "csnet_l_x2_224_inference_images_per_sec_per_chip[bf16]"


@pytest.fixture
def fake_card(monkeypatch):
    """The card's name, and tools.bench's row, faked: what bench_check
    does with them runs as on the card."""
    fresh = {"value": 1000.0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(timing, "card", lambda device: dict(CARD))
    monkeypatch.setattr(bench, "run", lambda device: {
        "metric": HEADLINE, "value": fresh["value"]})
    return fresh


def _reference(path, rows, card=CARD):
    path.write_text(json.dumps({**card, "rows": rows}))
    return str(path)


@pytest.mark.parametrize("case,value,rows,card,argv,passes", [
    ("within", 900.0, {HEADLINE: 1000.0}, CARD, [], True),
    ("regressed", 800.0, {HEADLINE: 1000.0}, CARD, [], False),
    ("nothing to compare", 1000.0, {"other[x]": 1.0}, CARD, [], False),
    ("another card", 1000.0, {HEADLINE: 1000.0},
     {**CARD, "power_limit": "500.00 W"}, [], False),
    ("another card, forced", 1000.0, {HEADLINE: 1000.0},
     {**CARD, "power_limit": "500.00 W"}, ["--force"], True),
])
def test_bench_check_verdicts_on_a_card(fake_card, tmp_path, capsys, case,
                                        value, rows, card, argv, passes):
    fake_card["value"] = value
    ref = _reference(tmp_path / "ref.json", rows, card)
    if passes:
        bench_check.main(["--reference", ref] + argv)
        assert "within tolerance" in capsys.readouterr().out
    else:
        with pytest.raises(SystemExit) as e:
            bench_check.main(["--reference", ref] + argv)
        assert e.value.code not in (0, None)


def test_bench_check_records_the_card_and_the_guarded_rows(fake_card,
                                                           tmp_path):
    extras = tmp_path / "extras.json"
    rows = [{"metric": m, "value": float(i + 1), "unit": "x"}
            for i, m in enumerate(bench_check.GUARDED_EXTRAS)]
    rows.append({"metric": "unguarded[x]", "value": 7.0, "unit": "x"})
    extras.write_text(json.dumps({**CARD, "entries": rows}))
    ref = tmp_path / "ref.json"
    with pytest.raises(SystemExit):  # no reference yet
        bench_check.main(["--reference", str(ref)])
    bench_check.main(["--record", "--reference", str(ref),
                      "--extras-json", str(extras)])
    got = json.loads(ref.read_text())
    assert {k: got[k] for k in CARD} == CARD
    assert got["rows"] == {HEADLINE: 1000.0, **{
        m: float(i + 1) for i, m in enumerate(bench_check.GUARDED_EXTRAS)}}
    bench_check.main(["--reference", str(ref), "--extras-json", str(extras)])
    # extras of another card are refused
    extras.write_text(json.dumps({"device": "cpu", "power_limit": None,
                                  "entries": rows}))
    with pytest.raises(SystemExit):
        bench_check.main(["--reference", str(ref), "--extras-json",
                          str(extras)])


def test_no_tool_imports_jax():
    """The tools run where there is no jax (the package-wide import test
    holds every module; this names the tools')."""
    import subprocess
    import sys

    code = ("import sys\nsys.modules['jax'] = None\n"
            "sys.modules['sod100k_tpu'] = None\n"
            "from sod100k_tpu_torch.tools import (bench, bench_check, "
            "bench_extras, bench_serve, perf_probe, timing)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_bench_golden_input_is_the_jax_tools():
    """bench.py:75-76: the golden's input, NHWC."""
    rng = np.random.default_rng(0)
    want = rng.standard_normal((2, 3, 224, 224),
                               dtype=np.float32).transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(bench.golden_input(), want)
    assert os.path.isfile(bench.GOLDEN)
    assert np.load(bench.GOLDEN)["logits"].shape == (2, 1, 224, 224)
