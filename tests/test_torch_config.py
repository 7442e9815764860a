"""The port's config layer, architecture registry, partial load and
parameter count against the JAX package's.

- ``get_cfg()`` of both packages agree key for key (names, values, types)
  but for the backend node: the JAX package's ``TPU`` is ``CUDA`` here,
  without MESH_DEVICES, PALLAS_DW and ORBAX (``_DROPPED``).
- The YAML-subset reader equals ``yaml.safe_load`` (YAML 1.1) on YAMLs
  written here: every key of the schema at a non-default value, the
  dot-less exponents that stay strings (``1e-20``), floats, flow lists,
  quoted strings, comments, the empty file. ``merge_from_file`` and
  ``merge_from_list`` of both packages give equal nodes; errors have the
  same types; what the reader does not understand, it refuses.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from sod100k_tpu.arch import get_arch as jget_arch
from sod100k_tpu.arch.csnet import csnet_init
from sod100k_tpu.arch.layer_config import init_layers as jinit_layers
from sod100k_tpu.config import get_cfg as jget_cfg
from sod100k_tpu.interop import torch_ckpt as jckpt
from sod100k_tpu.utils.profiler import count_params as jcount_params
from sod100k_tpu_torch.arch import get_arch, register_arch
from sod100k_tpu_torch.arch.csnet import CSNet
from sod100k_tpu_torch.arch.layer_config import init_layers
from sod100k_tpu_torch.config import get_cfg, miniyaml
from sod100k_tpu_torch.interop.torch_ckpt import (load_pretrained,
                                                  state_dict_from_pytree)
from sod100k_tpu_torch.train.checkpoint import save_checkpoint
from sod100k_tpu_torch.utils import profiler

# the JAX package's TPU node is CUDA here, less these keys
_DROPPED = {"MESH_DEVICES", "PALLAS_DW", "ORBAX"}


def _flat(node, prefix=""):
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _same(a, b) -> bool:
    return type(a) is type(b) and a == b


def test_defaults_agree_key_for_key():
    want = _flat(jget_cfg())
    got = _flat(get_cfg())
    jtpu = {k[4:]: v for k, v in want.items() if k.startswith("TPU.")}
    cuda = {k[5:]: v for k, v in got.items() if k.startswith("CUDA.")}
    assert set(jtpu) - set(cuda) == _DROPPED and set(cuda) <= set(jtpu)
    for k, v in cuda.items():
        assert _same(v, jtpu[k]), k
    rest_w = {k: v for k, v in want.items() if not k.startswith("TPU.")}
    rest_g = {k: v for k, v in got.items() if not k.startswith("CUDA.")}
    assert rest_w.keys() == rest_g.keys()
    for k, v in rest_w.items():
        assert _same(rest_g[k], v), k
    assert got["GPU"] == 0  # the reference's int leaf, not a node


def _other(v, i):
    """A non-default value of v's type, written as YAML text in a style
    that varies with i; returns (text, value it should merge as)."""
    if isinstance(v, bool):
        forms = ["false", "no", "Off", "FALSE"] if v else \
            ["True", "yes", "On", "TRUE"]
        return forms[i % 4], not v
    if isinstance(v, int):
        return str(v + 3), v + 3
    if isinstance(v, float):
        forms = [("1e-20", 1e-20), ("1.0e-4", 1e-4), ("2.5", 2.5),
                 ("-3.", -3.0), ("7", 7.0), ("'1e-3'", 1e-3)]
        return forms[i % len(forms)]
    if isinstance(v, str):
        forms = [('"alt run"', "alt run"), ("'it''s'", "it's"),
                 ("results/x-1", "results/x-1"), ("plain # a comment",
                                                  "plain")]
        return forms[i % len(forms)]
    if isinstance(v, list):
        if v and isinstance(v[0], str):
            return '["ECSSD", DUT-O]', ["ECSSD", "DUT-O"]
        if v and isinstance(v[0], float):
            return "[0.25, 0.75]", [0.25, 0.75]
        return "[5, 7, ]", [5, 7]
    raise AssertionError(type(v))


def _write_all_keys(path, node_name):
    """A YAML of every key of the JAX schema at a non-default value, with
    the backend node named ``node_name`` (its shared keys only)."""
    lines, expect = ["# every key at a non-default value", ""], {}
    i = 0

    def walk(node, indent, prefix):
        nonlocal i
        for k, v in node.items():
            name = node_name if (prefix, k) == ("", "TPU") else k
            if isinstance(v, dict):
                lines.append(" " * indent + f"{name}:   # node")
                walk({kk: vv for kk, vv in v.items()
                      if not (k == "TPU" and kk in _DROPPED)},
                     indent + 2, f"{prefix}{name}.")
                continue
            text, val = _other(v, i)
            i += 1
            lines.append(" " * indent + f"{name}: {text}")
            expect[f"{prefix}{name}"] = val

    walk(jget_cfg(), 0, "")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return expect


def test_reader_equals_pyyaml_and_merges_like_the_jax_package(tmp_path):
    jpath, path = tmp_path / "jax.yml", tmp_path / "port.yml"
    _write_all_keys(jpath, "TPU")
    expect = _write_all_keys(path, "CUDA")
    for p in (jpath, path):
        text = p.read_text()
        assert miniyaml.load(text) == yaml.safe_load(text)
    jcfg, cfg = jget_cfg(), get_cfg()
    jcfg.merge_from_file(str(jpath))
    cfg.merge_from_file(str(path))
    got, want = _flat(cfg), _flat(jcfg)
    for k, v in expect.items():
        assert _same(got[k], v), (k, got[k], v)
        jk = "TPU." + k[5:] if k.startswith("CUDA.") else k
        assert _same(want[jk], v), (jk, want[jk], v)
    assert isinstance(cfg.FINETUNE.THRES, float)  # the string->float path


@pytest.mark.parametrize("text", [
    "",
    "# only a comment\n\n",
    "A: 1e-20\nB: 1e-40\nC: 1.0e-4\nD: 1.0e4\nE: .5\nF: 1.\nG: -.inf\n"
    "H: +5\nI: -0\nJ: 1.5E-3\n",
    "A: yes\nB: On\nC: NO\nD: ~\nE:\nF: null\nG: TRUE\n",
    "A: [0.5, 0.5]\nB: [\"ECSSD\", 'DUT-O', plain]\nC: []\nD: [[1, 2], [3]]\n"
    "E: [1, 2, ]\n",
    "A: 'it''s' # c\nB: \"tab\\tq\\\"\"\nC: a#b\nD: -foo\nE: x y  # c\n",
    "TOP:\n  MID:\n    LEAF: 1\n    OTHER: [a]\n  NEXT: 2\nLAST: 3\n",
    "  INDENTED: 1\n  MAP:\n      DEEP: 2\n",
    "A: 1\nA: 2\n",
])
def test_reader_equals_pyyaml(text):
    assert miniyaml.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "A: &anchor 1\n",
    "A: *alias\n",
    "A: !!str 1\n",
    "A: |\n  block\n",
    "A: >\n  folded\n",
    "A: multi\n  line\n",
    "A: 'multi\n  line'\n",
    "A: [1,\n  2]\n",
    "A:\n  - 1\n  - 2\n",
    "A: {b: 1}\n",
    "A: 010\n",
    "A: 0x1f\n",
    "A: 1_000\n",
    "A: 1:30\n",
    "A: 2002-12-14\n",
    "---\nA: 1\n",
    "A: b: c\n",
    "\tA: 1\n",
])
def test_reader_refuses_what_it_does_not_understand(text):
    with pytest.raises(miniyaml.YAMLSubsetError):
        miniyaml.load(text)


def test_merge_from_list_matches_the_jax_package():
    opts = ["SOLVER.LR", "1e-3", "MODEL.BASIC_SPLIT", "[0.25, 0.75]",
            "TEST.DATASETS", '["ECSSD", "DUT-O"]', "AUTO.ENABLE", "True",
            "DATA.SAVEDIR", "out/run", "FINETUNE.THRES", "1e-20",
            "DATA.BATCH_SIZE", "24", "AUTO.FLOPS.WEIGHT", "3"]
    jcfg, cfg = jget_cfg(), get_cfg()
    jcfg.merge_from_list(opts)
    cfg.merge_from_list(opts)
    got, want = _flat(cfg), _flat(jcfg)
    for k in opts[0::2]:
        assert _same(got[k], want[k]), k


@pytest.mark.parametrize("text,error", [
    ("NOT_A_KEY: 1\n", KeyError),
    ("SOLVER:\n  NOT_A_KEY: 1\n", KeyError),
    ("AUTO:\n  ENABLE: 3\n", TypeError),
    ("SOLVER:\n  LR: [1]\n", TypeError),
    ("DATA: 1\n", TypeError),
])
def test_merge_errors_have_the_jax_types(tmp_path, text, error):
    path = tmp_path / "bad.yml"
    path.write_text(text)
    for make in (jget_cfg, get_cfg):
        with pytest.raises(error):
            make().merge_from_file(str(path))


def test_the_backend_node_of_the_other_package_is_refused(tmp_path):
    """A YAML with the JAX package's TPU node is refused here with a
    message that names CUDA, as the JAX package refuses a CUDA node."""
    tpu, cuda = tmp_path / "tpu.yml", tmp_path / "cuda.yml"
    tpu.write_text("TPU:\n  DTYPE: bfloat16\n")
    cuda.write_text("CUDA:\n  DTYPE: bfloat16\n")
    with pytest.raises(KeyError, match="CUDA:"):
        get_cfg().merge_from_file(str(tpu))
    with pytest.raises(KeyError):
        jget_cfg().merge_from_file(str(cuda))
    cfg = get_cfg()
    cfg.merge_from_file(str(cuda))
    assert cfg.CUDA.DTYPE == "bfloat16"


def test_registry_names_and_builds():
    import sod100k_tpu.arch as jarch
    import sod100k_tpu_torch.arch as arch

    assert set(arch._REGISTRY) == set(jarch._REGISTRY) == {
        "csnet", "csf_res2net50", "csf_res2net101"}
    for name in ("csnet", "csf_res2net50", "csf_res2net101"):
        assert callable(get_arch(name))
        jget_arch(name)
    for getter in (get_arch, jget_arch):
        with pytest.raises(KeyError, match="csnet"):
            getter("csnett")
    model = get_arch("csnet")(init_layers(8, [0.5, 0.5]), device="cpu",
                              seed=3)
    assert isinstance(model, CSNet)
    register_arch("csnet_twin", get_arch("csnet"))
    try:
        assert get_arch("csnet_twin") is get_arch("csnet")
    finally:
        del arch._REGISTRY["csnet_twin"]


def test_load_pretrained_overlays_as_the_jax_package(tmp_path):
    """A checkpoint with one tensor of another shape and one missing: both
    packages keep the model's value for those and take the rest."""
    lc = init_layers(8, [0.5, 0.5])
    current = CSNet(lc, seed=0, device="cpu")
    donor = CSNet(lc, seed=1, device="cpu")
    path = str(tmp_path / "donor.pth.tar")
    save_checkpoint(path, donor, None, epoch=3)
    ck = torch.load(path, weights_only=False)
    sd = ck["state_dict"]
    sd["cls_layer.weight"] = sd["cls_layer.weight"][:, :-1]
    del sd["stage1.0.conv1x1.bns.0.weight"]
    torch.save(ck, path)

    want = jckpt.load_pretrained(
        jckpt.state_dict_to_pytree(current.state_dict()), path)
    taken = load_pretrained(current, path)
    assert "cls_layer.weight" not in taken
    assert "stage1.0.conv1x1.bns.0.weight" not in taken
    assert "cls_layer.bias" in taken
    got = current.state_dict()
    for k, v in state_dict_from_pytree(want).items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    keep = CSNet(lc, seed=0, device="cpu").state_dict()
    for k in ("cls_layer.weight", "stage1.0.conv1x1.bns.0.weight"):
        assert torch.equal(got[k], keep[k])


@pytest.mark.parametrize("width,split", [(8, [0.5, 0.5]), (20, [1])])
def test_count_params_equals_the_jax_count(width, split):
    import jax

    lc = init_layers(width, split)
    jparams = jax.eval_shape(lambda: csnet_init(
        jax.random.key(0), jinit_layers(width, split)))
    assert profiler.count_params(CSNet(lc, device="cpu")) == \
        jcount_params(jparams)


def test_count_params_of_csf_equals_the_jax_count():
    """From the JAX leaf shapes (``jax.eval_shape``; csf_init itself takes
    ~30 s on the CPU)."""
    import jax

    from sod100k_tpu.arch.csf_res2net import csf_init
    from sod100k_tpu_torch.arch.csf_res2net import CSFNet

    shapes = jax.eval_shape(lambda: csf_init(jax.random.key(0),
                                             backbone="res2net50"))
    assert profiler.count_params(CSFNet("res2net50", device="cpu")) == \
        jcount_params(shapes)


def test_simplesum_and_meters():
    model = CSNet(init_layers(8, [0.5, 0.5]), device="cpu")
    n, flops = profiler.simplesum(model, (32, 32, 3))
    assert n == profiler.count_params(model) and flops > 0
    assert profiler.simplesum(model, (64, 64, 3))[1] == pytest.approx(
        4 * flops, rel=0.05)  # convolutions scale with the pixels


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiler.trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
