"""A tree that holds the measured cell ``csf-r2n50.train-b8``, which
``BENCHMARK.json`` leaves out (its throughput spreads too widely for the
shared bound): the benchmark's entries with the cell's added, and the
configuration and traffic files, for ``run.run_cell(..., root=...)``."""

import json
import os
import shutil

import pytest

from benchmark import run

CSF_TRAIN = {"name": "csf-r2n50.train-b8", "config": "csf-r2n50",
             "traffic": "train-b8", "chips": 1,
             "why": "the CSF Solver's step at B=8, iter_size 2"}


@pytest.fixture
def csf_train_root(tmp_path) -> str:
    bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    bench["workloads"].append(CSF_TRAIN)
    next(m for m in bench["end_to_end"]
         if m["name"] == "train_img_per_s")["workloads"].append(
             CSF_TRAIN["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for sub in ("configs", "traffic"):
        shutil.copytree(os.path.join(run.HERE, sub),
                        tmp_path / "benchmark" / sub)
    return str(tmp_path)
