"""A model family is new files alone: a toy family (two convolutions, a
batch norm and a bilinear resize) put into a copy of the tree as a family
module and its reference, with its configuration, traffic and entries,
serves and trains through ``run.run_cell`` on the CPU, ``benchmark.counts``
counts it, and the family-wide tests take it up with no edit; the harness
outside ``benchmark/families/`` compares no family name."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import families, train_cell

ROOT = __file__.rsplit("/benchmark/", 1)[0]
SEED = 2**31 + 5151

TOY_REFERENCE = '''"""The toy's plain forward: conv 3x3 stride 2 with a bias, batch
norm, ReLU, conv 1x1 with a bias, bilinear resize back to the input."""

import torch.nn.functional as F

from .common import Norms, conv, normalize_u8, resize


def forward(state, images_u8, norms=None):
    x = normalize_u8(images_u8)
    y = conv(x, state["conv1.weight"], state["conv1.bias"], stride=2,
             padding=1)
    y = F.relu((norms or Norms()).bn(y, state, "bn1"))
    y = conv(y, state["conv2.weight"], state["conv2.bias"])
    return resize(y, x.shape[2:])
'''

TOY = '''"""A toy family, its forward in ``reference/toy.py``."""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..reference import toy
from ..reference.common import Norms
from ..reference.train import Adam


class Family:
    def __init__(self, cfg):
        self.cfg = cfg

    def spec(self):
        return [("conv1.weight", (8, 3, 3, 3), "conv"),
                ("conv1.bias", (8,), "conv_bias"),
                ("bn1.weight", (8,), "norm_weight"),
                ("bn1.bias", (8,), "norm_bias"),
                ("bn1.running_mean", (8,), "mean"),
                ("bn1.running_var", (8,), "var"),
                ("bn1.num_batches_tracked", (), "count"),
                ("conv2.weight", (1, 8, 1, 1), "conv"),
                ("conv2.bias", (1,), "conv_bias")]

    def forward(self, state, images_u8, norms=None):
        return toy.forward(state, images_u8, norms)

    def count_forward(self, state, images_u8):
        self.forward(state, images_u8)
        return {}

    def program_model(self, state, device):
        model = Toy().to(device)
        model.load_state_dict(state, strict=True)
        return model

    def serving_model(self, state, device, workdir):
        return Served(self.program_model(state, device), self.cfg)

    def micro_steps(self, traffic):
        return 1

    def program_step(self, model, traffic):
        from sod100k_tpu_torch.train.csf_step import CSFTrainStep

        opt = torch.optim.Adam(model.parameters(), lr=0.0,
                               betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=traffic["weight_decay"])
        run = CSFTrainStep(model, opt, iter_size=1,
                           batch_size=traffic["batch"], from_u8=True)
        return opt, lambda image, target: run(
            {"image": image, "target": target}, traffic["lr"])["loss"]

    def reference_recipe(self, state, traffic):
        return Recipe(self, state, traffic)

    def reference_step(self, recipe, micro_batches, traffic):
        (image, target), = micro_batches
        return recipe.step(image, target, traffic["lr"])


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3, stride=2, padding=1)
        self.bn1 = nn.BatchNorm2d(8)
        self.conv2 = nn.Conv2d(8, 1, 1)

    def forward(self, x):
        from sod100k_tpu_torch.ops.resample import resize_bilinear

        img = x.permute(0, 3, 1, 2)
        y = self.conv2(F.relu(self.bn1(self.conv1(img))))
        return resize_bilinear(y, tuple(img.shape[2:])).permute(0, 2, 3, 1)


class Served:
    def __init__(self, model, cfg):
        from sod100k_tpu_torch.train.step import make_eval_step

        self.step = make_eval_step(model, from_u8=True, quantize_u8=True)
        self.batches = [max(cfg["buckets"])]
        hw = int(cfg["hw"])
        self.meta = {"wire": "u8", "batch": self.batches[0], "h": hw,
                     "w": hw}
        self.input_shape = (self.batches[0], hw, hw, 3)

    def __call__(self, images):
        x = torch.from_numpy(np.ascontiguousarray(images, np.uint8))
        return self.step(x).cpu().numpy()


class Recipe:
    def __init__(self, fam, state, traffic):
        self.fam, self.batch = fam, traffic["batch"]
        self.state = {k: v.clone() for k, v in state.items()}
        self.params = {n: self.state[n] for n, _, kind in fam.spec()
                       if kind not in ("mean", "var", "count")}
        self.opt = Adam(self.params, {k: traffic["weight_decay"]
                                      for k in self.params}, 0.9, 0.999)

    def step(self, image, target, lr):
        for p in self.params.values():
            p.requires_grad_(True)
        logits = self.fam.forward(self.state, image, Norms("train"))
        t = target.permute(0, 3, 1, 2).float() / 255.0
        loss = F.binary_cross_entropy_with_logits(
            logits, t, reduction="sum") / self.batch
        grads = torch.autograd.grad(loss, list(self.params.values()))
        for p in self.params.values():
            p.requires_grad_(False)
        seen = self.opt.step(dict(zip(self.params, grads)), lr)
        return {"loss": float(loss.detach()), "grads": seen}
'''

CONFIG = {"family": "toy", "hw": 32, "dtype": "float32", "tf32": False,
          "buckets": [1, 4], "wire": "u8",
          # 2 x 8 x 16^2 x 27 (conv1) + 2 x 16^2 x 8 (conv2)
          "flops_per_img": 114688}
TRAFFIC = {
    "toy.serve": {"kind": "serve", "loop": "open", "sizes": [1, 2],
                  "rate_img_s": 24, "pool": 8, "max_wait_ms": 3.0,
                  "limits": {"gap_levels": 0.5, "failed": 0}},
    "toy.train": {"kind": "train", "batch": 4, "lr": 1e-3,
                  "weight_decay": 5e-4, "resident_batches": 4,
                  "limits": {"loss_gap": 1e-4, "grad_gap": 1e-3,
                             "change_gap": 1e-3}}}

RUN = """
import json
from benchmark import counts, run
print(json.dumps({"counts": counts.count(run.load_json(
    "benchmark/configs/toy.json")), **{
    cell: run.run_cell(cell, %d, 1.0, False, "cpu")
    for cell in ("toy.serve", "toy.train")}}))
""" % SEED


def _tree_with_the_toy(tmp: str) -> list:
    """A copy of the benchmark with the toy family added as new files and
    new entries; returns the files added."""
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "sod100k_tpu_torch"),
               os.path.join(tmp, "sod100k_tpu_torch"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    added = {"benchmark/families/toy.py": TOY,
             "benchmark/reference/toy.py": TOY_REFERENCE,
             "benchmark/configs/toy.json": json.dumps(CONFIG)}
    for cell, traffic in TRAFFIC.items():
        added[f"benchmark/traffic/{cell}.json"] = json.dumps(traffic)
    for path, text in added.items():
        assert not os.path.exists(os.path.join(tmp, path))
        with open(os.path.join(tmp, path), "w") as f:
            f.write(text)
    bench["configs"].append({"name": "toy", "source": "a test",
                             "file": "benchmark/configs/toy.json",
                             "reduced": [], "why": "a test"})
    for cell, moves in (("toy.serve", "serve_p50_ms"),
                        ("toy.train", "train_img_per_s")):
        bench["workloads"].append({"name": cell, "config": "toy",
                                   "traffic": cell.split(".")[1],
                                   "chips": 1, "why": "a test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if moves in (m["name"], m.get("moves")):
                m["workloads"].append(cell)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return sorted(added)


def test_a_new_family_is_new_files_and_entries_alone(tmp_path):
    _tree_with_the_toy(str(tmp_path))
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["counts"] == {"flops_per_img": CONFIG["flops_per_img"]}
    serve, train = got["toy.serve"], got["toy.train"]
    assert serve["correct"] and train["correct"], (serve["checks"],
                                                   train["checks"])
    assert set(serve["metrics"]) == {"setup_s", "serve_p50_ms"}
    assert set(train["metrics"]) == {"setup_s", "train_img_per_s"}
    assert serve["attempted"] > 5 and serve["failed"] == 0
    assert train["attempted"] > 3


def test_an_unknown_family_is_refused():
    here = os.path.join(ROOT, "benchmark", "families")
    on_disk = sorted(name[:-3] for name in os.listdir(here)
                     if name.endswith(".py") and not name.startswith("_"))
    assert families.names() == on_disk
    assert {"csf", "csnet"} <= set(on_disk)
    # no module can be named so
    with pytest.raises(ValueError, match=re.escape(
            f"'no-such-family'; one of {on_disk}")):
        families.family({"family": "no-such-family"})


# The tests that hold every family, configuration or reference module
# there is, wherever it came from; ``-k`` keeps their cases of the toy
# and the tests that take no case a family
FAMILY_WIDE = [
    "test_benchmark_nojax.py::test_reference_loads_nothing_of_the_port",
    "test_benchmark_counts.py::test_config_counts_are_current",
    "test_benchmark_reference.py::test_eval_forward_matches_the_port",
    "test_benchmark_spec.py",
    "test_benchmark_families.py::test_an_unknown_family_is_refused"]
TOY_CASES = "toy or loads_nothing or spec or unknown"


def _pytest(tmp: str, tests: list) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "-k", TOY_CASES, *[f"benchmark/tests/{t}" for t in tests]],
        cwd=tmp, capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("planted", [False, True],
                         ids=["sound", "reference-loads-the-port"])
def test_the_family_wide_tests_take_a_new_family(tmp_path, planted):
    tmp = str(tmp_path)
    _tree_with_the_toy(tmp)
    shutil.copytree(os.path.join(ROOT, "benchmark", "tests"),
                    os.path.join(tmp, "benchmark", "tests"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    if not planted:
        out = _pytest(tmp, FAMILY_WIDE)
        assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
        for case in ("test_config_counts_are_current[toy] PASSED",
                     "test_eval_forward_matches_the_port[toy.json] PASSED",
                     "test_reference_loads_nothing_of_the_port PASSED",
                     "test_an_unknown_family_is_refused PASSED",
                     "test_benchmark_spec.py::"):
            assert case in out.stdout, out.stdout[-4000:]
        return
    # the new reference module is among those held to load nothing of
    # the port
    with open(os.path.join(tmp, "benchmark", "reference", "toy.py"),
              "a") as f:
        f.write("\nimport sod100k_tpu_torch.ops.resample  # noqa\n")
    out = _pytest(tmp, FAMILY_WIDE[:1])
    assert out.returncode == 1, out.stdout[-4000:]


def test_a_family_without_a_recipe_takes_no_train_cell(monkeypatch):
    class Serving:
        def __init__(self, cfg):
            self.cfg = cfg

    monkeypatch.setattr(train_cell, "family", Serving)
    with pytest.raises(ValueError, match="no training recipe"):
        train_cell.run({"family": "serving", "hw": 32}, {"batch": 1}, SEED,
                       1.0, False, None, 0.0, print)


def _compares_a_family(tree: ast.AST, names: set) -> list:
    """Lines that compare a family's name, or look a family up by name: a
    comparison with a family's name, a ``["family"]``, ``.get("family")``
    or ``.family``; a subscript by one of those; a dict keyed by names."""
    def named(node) -> bool:
        if isinstance(node, ast.Constant):
            return node.value in names or node.value == "family"
        if isinstance(node, ast.Attribute):
            return node.attr == "family"
        if isinstance(node, ast.Subscript):
            return named(node.slice)
        if isinstance(node, ast.Call):
            return any(named(a) for a in node.args)
        return False

    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare) and \
                any(named(x) for x in [node.left, *node.comparators]):
            bad.append(node.lineno)
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.slice, (ast.Subscript, ast.Call,
                                        ast.Attribute)) and \
                named(node.slice):
            bad.append(node.lineno)
        elif isinstance(node, ast.Dict) and \
                any(isinstance(k, ast.Constant) and k.value in names
                    for k in node.keys):
            bad.append(node.lineno)
    return bad


def test_no_module_outside_families_compares_a_family_name():
    names = set(families.names())
    here = os.path.join(ROOT, "benchmark")
    found = {}
    for dirpath, dirs, files in os.walk(here):
        dirs[:] = [d for d in dirs if d not in ("families", "tests",
                                                "__pycache__")]
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    bad = _compares_a_family(ast.parse(f.read()), names)
                if bad:
                    found[os.path.relpath(path, ROOT)] = bad
    assert found == {}
    # the check finds what the harness compared before
    assert sorted(_compares_a_family(ast.parse(
        'if cfg["family"] == "csnet":\n    pass\n'
        'x = {"csnet": 1, "csf": 2}[cfg.get("family")]\n'), names)) == [
            1, 3, 3]
