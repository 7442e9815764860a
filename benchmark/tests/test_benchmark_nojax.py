"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference, every module of it there is, loads
nothing of the port."""

import os
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
        "import importlib, pkgutil\n"
        "import benchmark.reference as ref, benchmark.weights, "
        "benchmark.check\n"
        "for m in pkgutil.iter_modules(ref.__path__):\n"
        "    importlib.import_module(ref.__name__ + '.' + m.name)")
    here = os.path.join(ROOT, "benchmark", "reference")
    on_disk = {"benchmark.reference." + name[:-3]
               for name in os.listdir(here) if name.endswith(".py")
               and name != "__init__.py"}
    assert on_disk and on_disk <= mods
    assert not {m for m in mods if m.split(".")[0] == "sod100k_tpu_torch"}
    assert loaded_forbidden(mods) == []
