"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference loads nothing of the port."""

import subprocess
import sys

from benchmark.run import loaded_forbidden

ROOT = __file__.rsplit("/benchmark/", 1)[0]


def test_forbidden_names_are_compared_whole():
    mods = {"sod100k_tpu_torch", "sod100k_tpu_torch.serve", "jaxtyping",
            "numpy", "flax.linen", "jaxlib", "sod100k_tpu.arch"}
    assert loaded_forbidden(mods) == ["flax.linen", "jaxlib",
                                      "sod100k_tpu.arch"]
    assert loaded_forbidden({"sod100k_tpu_torch.ops"}) == []


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print('\\n'.join(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    mods = _modules_after(
        "import benchmark.run, benchmark.serve_cell, benchmark.train_cell, "
        "benchmark.control, benchmark.sweep, benchmark.loadgen\n"
        "import sod100k_tpu_torch.serve, sod100k_tpu_torch.serve_http\n"
        "import sod100k_tpu_torch.train.step, sod100k_tpu_torch.train.optim\n"
        "import sod100k_tpu_torch.train.csf_step")
    assert loaded_forbidden(mods) == []


def test_reference_loads_nothing_of_the_port():
    mods = _modules_after(
        "import benchmark.reference.csnet, benchmark.reference.csf, "
        "benchmark.reference.train, benchmark.weights, benchmark.check")
    assert not {m for m in mods if m.split(".")[0] == "sod100k_tpu_torch"}
    assert loaded_forbidden(mods) == []
