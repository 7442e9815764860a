"""The port's drivers (``sod100k_tpu_torch.cli``) against the JAX package's
(``cli``) on one synthetic PNG tree: 8 train and 4 test pairs at about
80x96, CSNet ``init_layers(8, [0.5, 0.5])`` through AUTO.PREDEFINE, 64^2,
DATA.BATCH_SIZE 4. The two packages never draw the same weights from one
seed, so they share them through files: DATA.PRETRAIN for training,
TEST.CHECKPOINT for test (weights with BN statistics calibrated on the
test images: a fresh x100 net explodes or dies in eval mode). Each JAX
driver runs once per module fixture.

Bars:
- train (host and hybrid front-ends, one epoch of two Adam-dwd steps at lr
  1e-4): the first step's loss and penalty within rel 1e-4, the second's
  within 1e-3 and 2e-4; the change each package makes from the shared
  init, port against JAX as |port - JAX| / |JAX|: the first step's per
  tensor under 1e-2, the epoch's per kind of tensor (conv weight, BN
  bias, ...) under 0.2. A parameter is read where the JAX gradient
  exceeds 0.2 of its tensor's largest. The JAX package's f32 gradient on
  the CPU is ~4% (L2) from an f64 one here, the port's ~1e-4: about 1% of
  the JAX first-step updates take the other sign, some at a tenth of their
  tensor's largest gradient, and the second step builds on them. Measured
  readings: first step <= 1e-4, epoch <= 0.10; controls (the port with
  half the lr, without the penalty, without weight decay) >= 2x a bar,
  a run that never steps 1.0. The two drivers' weight-decay split is
  compared directly: Adam's sign-like steps hide a wrong split of the BN
  weights, whose gradients are ~100x their decay;
- finetune: both prune one checkpoint to the same layer_config file, then
  one finetune epoch at the train bars;
- test (fixed 64^2, ceil-to-16, TEST.BATCH 2): decoded PNG maps within one
  level, in both checkpoint directions.
"""

import os

import shutil
import threading
import urllib.request
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch

from sod100k_tpu.config import get_cfg as jget_cfg
from sod100k_tpu.interop.torch_ckpt import (pytree_to_state_dict,
                                            state_dict_to_pytree)
from sod100k_tpu_torch.arch.csnet import CSNet, calibrate_bn
from sod100k_tpu_torch.arch.layer_config import LayerConfig, init_layers
from sod100k_tpu_torch.cli import export as cexport
from sod100k_tpu_torch.cli import serve as cserve
from sod100k_tpu_torch.cli import test as ctest
from sod100k_tpu_torch.cli import train as ctrain
from sod100k_tpu_torch.config import get_cfg
from sod100k_tpu_torch.data.image_io import (decode_png, encode_png,
                                             read_image, resize_u8_linear)
from sod100k_tpu_torch.data.pipeline import (IMAGENET_MEAN, IMAGENET_STD,
                                             _imread_rgb_u8, normalize_u8)
from sod100k_tpu_torch.data.synth import make_synth_split
from sod100k_tpu_torch.serve import load_artifact
from sod100k_tpu_torch.train.checkpoint import save_checkpoint
from sod100k_tpu_torch.train.step import make_eval_step, make_train_step

cv2 = pytest.importorskip("cv2")

HW = 64
SPLIT = [0.5, 0.5]
STEP_FLOOR = 0.2
STEP1_REL = 1e-2
RUN_REL = 0.2
LOSS2_REL = 1e-3
PENALTY2_REL = 2e-4


def _quiet(*_, **__):
    pass


class _Log(list):
    """A driver log that keeps its lines."""

    def __call__(self, msg, display=True):
        self.append(str(msg))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    make_synth_split(str(root / "DUTS-TR"), 8, hw=(80, 96), seed=3)
    # one shape (78x90, ceil-to-16 80x96): one compile per JAX test mode
    make_synth_split(str(root / "ECSSD"), 4, hw=(78, 90),
                     alternate_orientation=False, seed=4)
    return root


@pytest.fixture(scope="module")
def shared(tree, tmp_path_factory):
    """The files both packages read: the layer config, the training init
    and a calibrated checkpoint, written by the port and (the same
    weights) by the JAX package."""
    from cli.common import save_torch_checkpoint

    d = tmp_path_factory.mktemp("shared")
    lc = init_layers(8, SPLIT)
    lc.save(str(d / "predefine.bin"))
    save_checkpoint(str(d / "init.pth.tar"), _pretrained(lc), None, epoch=0)
    model = CSNet(lc, seed=1, device="cpu")
    imgs = np.stack([resize_u8_linear(_imread_rgb_u8(p), (HW, HW))
                     for p in _images(tree / "ECSSD")])
    calibrate_bn(model, normalize_u8(torch.from_numpy(imgs)))
    save_checkpoint(str(d / "calib.pth.tar"), model, None, epoch=5)
    save_torch_checkpoint(str(d / "calib_jax.pth.tar"),
                          state_dict_to_pytree(model.state_dict()), epoch=5,
                          arch="csnet")
    return {k: str(d / f) for k, f in (
        ("predefine", "predefine.bin"), ("init", "init.pth.tar"),
        ("calib", "calib.pth.tar"), ("calib_jax", "calib_jax.pth.tar"))}


def _pretrained(lc):
    """A stand-in for pretrained weights (DATA.PRETRAIN): the seeded init
    with BN shifts drawn N(0, 0.1) in place of zeros."""
    model = CSNet(lc, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.normal_(0.0, 0.1, generator=gen)
    return model


def _images(split):
    d = os.path.join(split, "images")
    return [os.path.join(d, n) for n in sorted(os.listdir(d))]


def _set(cfg, values: dict) -> None:
    for key, v in values.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = v


def _cfgs(tree, shared, save, task, backend=None):
    """The same config for both packages: (JAX cfg, port cfg)."""
    values = {
        "TASK": task, "PRINT_FREQ": 1, "MODEL.BASIC_SPLIT": SPLIT,
        "LOSS.MLOSS": 1, "DATA.DIR": str(tree / "DUTS-TR"),
        "DATA.BATCH_SIZE": 4, "DATA.WORKERS": 2, "DATA.SAVEDIR": str(save),
        "DATA.IMAGE_H": HW, "DATA.IMAGE_W": HW,
        "VAL.DIR": str(tree / "ECSSD"), "TEST.DATASET_PATH": str(tree),
        "TEST.DATASETS": ["ECSSD"], "TEST.IMAGE_H": HW, "TEST.IMAGE_W": HW,
        "TEST.MODEL_CONFIG": shared["predefine"],
        "AUTO.ENABLE": True, "AUTO.PREDEFINE": shared["predefine"],
        "AUTO.FLOPS.ENABLE": True, "AUTO.FLOPS.WEIGHT": 3.0,
        "AUTO.FLOPS.EXPAND": 1.0, "DATA.PRETRAIN": shared["init"],
        "SOLVER.METHOD": "Adam_dynamic_weight_decay", "SOLVER.LR": 1e-4,
        "FINETUNE.THRES": 1.0, "FINETUNE.SOLVER.LR": 1e-4,
        "FINETUNE.SOLVER.LR_SCHEDULER": "cosine",
        "FINETUNE.SOLVER.ADJUST_STEP": True,
    }
    jcfg, cfg = jget_cfg(), get_cfg()
    _set(jcfg, values)
    _set(cfg, values)
    jcfg.TPU.MESH_DEVICES = 1
    for k, v in (backend or {}).items():
        jcfg.TPU[k] = v
        cfg.CUDA[k] = v
    return jcfg, cfg


def _recording(make, rec):
    """A train-step factory whose steps record their loss and penalty, the
    weights the first step starts from (``init``) and ends on (``step1``),
    the first moment of Adam after each step (``moments``: (1 - b1) times
    the gradient at step 1, weight decay included) and, on the port's
    side, each call's arguments (``calls``) and the parameters without
    weight decay (``no_decay``)."""

    def wrapped(*a, **k):
        step = make(*a, **k)
        model = a[0] if isinstance(a[0], torch.nn.Module) else None
        port = model is not None
        if port:  # the parameters the optimizer does not decay
            names = {id(p): n for n, p in model.named_parameters()}
            rec["no_decay"] = sorted(
                names[id(p)] for g in a[1].param_groups
                if not g["weight_decay"] for p in g["params"])

        def run(*args):
            first = not rec["losses"]
            if first:  # before the call: the JAX step donates its inputs
                rec["init"] = (_numpy_sd(model.state_dict()) if port
                               else _jax_sd(args[0], args[1]))
            if port:
                rec.setdefault("calls", []).append(
                    ({k: np.array(v) for k, v in args[0].items()},
                     *args[1:]))
            out = step(*args)
            rec.setdefault("moments", []).append(
                _torch_moment(model, a[1]) if port
                else _adam_moment(out[2]))
            if first:
                rec["step1"] = (_numpy_sd(model.state_dict()) if port
                                else _jax_sd(out[0], out[1]))
            m = out[-1] if isinstance(out, tuple) else out
            rec["losses"].append((float(m["loss"]), float(m["penalty"])))
            return out

        return run

    return wrapped


def _numpy_sd(sd) -> dict:
    return {k: v.detach().float().numpy().copy() for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def _jax_sd(*trees) -> dict:
    out = {}
    for t in trees:
        out.update({k: np.array(v, np.float32)
                    for k, v in pytree_to_state_dict(t).items()})
    return out


def _adam_moment(opt_state) -> dict:
    import optax

    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return _jax_sd(adam.mu)


def _train(mode, tree, shared, tmp_path_factory):
    """One epoch (two steps) of both train drivers from the shared init."""
    import cli.train as jtrain
    import sod100k_tpu.utils.profiler as jprofiler

    save = tmp_path_factory.mktemp(f"train_{mode}")
    jcfg, cfg = _cfgs(tree, shared, save / "jax", "run",
                      {"PREPROCESS": mode})
    if mode == "hybrid":  # one JAX eval compile less
        jcfg.VAL.DIR = cfg.VAL.DIR = ""
    mp = pytest.MonkeyPatch()
    # the JAX startup line's FLOPs come from an XLA compile of the forward
    # (another count than the port's, not compared): skip that compile
    mp.setattr(jprofiler, "simplesum",
               lambda fn, params, size: (jprofiler.count_params(params), 0.0))
    jrec, prec = {"losses": []}, {"losses": []}
    mp.setattr(jtrain, "make_train_step",
               _recording(jtrain.make_train_step, jrec))
    mp.setattr(ctrain, "make_train_step",
               _recording(ctrain.make_train_step, prec))
    try:
        jout = jtrain.run_training(jcfg, max_epochs=1, log=_quiet)
        cfg.DATA.SAVEDIR = str(save / "port")
        out = ctrain.run_training(cfg, max_epochs=1, log=_quiet,
                                  device="cpu")
    finally:
        mp.undo()
    return {"mode": mode, "cfg": cfg, "jcfg": jcfg, "jout": jout,
            "out": out, "jax": jrec, "port": prec,
            "jax_ckpt": os.path.join(jout["dirs"]["checkpoint"],
                                     "checkpoint_epoch1.pth.tar"),
            "port_ckpt": os.path.join(out["dirs"]["checkpoint"],
                                      "checkpoint_epoch1.pth.tar")}


@pytest.fixture(scope="module")
def trained_host(tree, shared, tmp_path_factory):
    return _train("host", tree, shared, tmp_path_factory)


@pytest.fixture(scope="module")
def trained_hybrid(tree, shared, tmp_path_factory):
    return _train("hybrid", tree, shared, tmp_path_factory)


def _state(path):
    return _numpy_sd(torch.load(path, map_location="cpu",
                                weights_only=False)["state_dict"])


def _torch_moment(model, optimizer) -> dict:
    return {n: optimizer.state[p]["exp_avg"].detach().numpy().copy()
            for n, p in model.named_parameters()}


def _jax_no_decay(init: dict, decay_conv3x3_2: bool) -> list:
    """The parameters the JAX Adam-dwd does not decay, by state-dict key."""
    from sod100k_tpu.train.optim import _wd_mask
    from sod100k_tpu.train.params import partition

    trainable, _ = partition(state_dict_to_pytree(init))
    mask = jax.tree.map(lambda m, t: np.full(t.shape, m),
                        _wd_mask(trainable, decay_conv3x3_2), trainable)
    return sorted(k for k, m in _jax_sd(mask).items() if not m.any())


def _kind(key: str) -> str:
    """The kind of tensor a state-dict key names: conv weight or bias, BN
    weight or bias, PReLU weight, BN running mean or variance."""
    leaf = key.rsplit(".", 1)[1]
    if leaf.startswith("running"):
        return leaf
    if ".bns." in key:
        return "bn." + leaf
    return "prelu" if ".prelus." in key else "conv." + leaf


def _changes(init: dict, want: dict, got: dict, moments: list):
    """(key, JAX change, port change) from the shared init. A parameter is
    read on the elements where each recorded first moment of the JAX Adam
    exceeds STEP_FLOOR of its tensor's largest; BN running statistics on
    every element."""
    for k, p0 in init.items():
        dw, dg = want[k] - p0, got[k] - p0
        if k in moments[0]:
            keep = np.all([np.abs(m[k]) > STEP_FLOOR * np.abs(m[k]).max()
                           for m in moments], axis=0)
            dw, dg = dw[keep], dg[keep]
        yield k, dw, dg


def _per_kind(want: dict, got: dict) -> dict:
    """|got - want| / |want| over each kind of tensor."""
    num, den = {}, {}
    for k, w in want.items():
        g = _kind(k)
        num[g] = num.get(g, 0.0) + float(np.sum((got[k] - w) ** 2))
        den[g] = den.get(g, 0.0) + float(np.sum(w ** 2))
    return {g: (num[g] / den[g]) ** 0.5 for g in num}


def _readings(jrec, prec, want: dict, got: dict) -> tuple[dict, dict]:
    """The first step's readings per tensor and the run's per kind:
    |port change - JAX change| / |JAX change|."""
    init = jrec["init"]
    for k, v in init.items():  # one start, as each package loaded it
        np.testing.assert_array_equal(prec["init"][k], v, err_msg=k)
    step1 = {}
    for k, dw, dg in _changes(init, jrec["step1"], prec["step1"],
                              jrec["moments"][:1]):
        assert np.linalg.norm(dw) > 0, k
        step1[k] = float(np.linalg.norm(dg - dw) / np.linalg.norm(dw))
    changes = {k: (dw, dg)
               for k, dw, dg in _changes(init, want, got, jrec["moments"])}
    return step1, _per_kind({k: c[0] for k, c in changes.items()},
                            {k: c[1] for k, c in changes.items()})


def _changes_close(jrec, prec, want: dict, got: dict) -> None:
    step1, run = _readings(jrec, prec, want, got)
    worst = max(step1, key=step1.get)
    assert step1[worst] < STEP1_REL, (worst, step1[worst])
    worst = max(run, key=run.get)
    assert run[worst] < RUN_REL, (worst, run)


@pytest.mark.parametrize("mode", ["host", "hybrid"])
def test_train_matches_the_jax_driver(request, mode):
    trained = request.getfixturevalue(f"trained_{mode}")
    jrec, prec = trained["jax"], trained["port"]
    assert len(jrec["losses"]) == len(prec["losses"]) == 2
    (jl1, jp1), (jl2, jp2) = jrec["losses"]
    (l1, p1), (l2, p2) = prec["losses"]
    assert (l1, p1) == (pytest.approx(jl1, rel=1e-4),
                        pytest.approx(jp1, rel=1e-4))
    assert (l2, p2) == (pytest.approx(jl2, rel=LOSS2_REL),
                        pytest.approx(jp2, rel=PENALTY2_REL))
    _changes_close(jrec, prec, _state(trained["jax_ckpt"]),
                   _state(trained["port_ckpt"]))
    assert prec["no_decay"] == _jax_no_decay(jrec["init"],
                                             trained["jcfg"].TPU.WD_QUIRK)
    jh, h = trained["jout"]["history"], trained["out"]["history"]
    assert [sorted(e) for e in h] == [sorted(e) for e in jh]
    assert [e["epoch"] for e in h] == [1]
    if trained["mode"] == "host":  # val MAE on both sides
        assert h[0]["mae"] == pytest.approx(jh[0]["mae"], abs=1e-3)
        assert trained["out"]["best_epoch"] == trained["jout"]["best_epoch"]
    base = os.path.dirname(trained["port_ckpt"])
    assert sorted(os.listdir(base)) == sorted(
        os.listdir(os.path.dirname(trained["jax_ckpt"])))
    ck = torch.load(trained["port_ckpt"], weights_only=False)
    assert ck["epoch"] == 1 and "param_groups" in ck["optimizer"]


def test_train_tracks_an_f64_replay(trained_host):
    """The port's step and optimizer in float64 replay the driver's two
    calls (its batches, lr and penalty switch) from the shared init. The
    port's driver tracks the replay: the first step's Adam moments within
    L2-rel 1e-3 per kind of tensor, the second step's loss within rel
    1e-4, the epoch's changes per kind within 0.05. The JAX driver's first
    moments are further (held under 0.1) and its second-step loss within
    the parity bar of the replay's: the f32 noise the bars above allow
    for is the JAX package's."""
    from sod100k_tpu_torch.train import optim

    cfg, jrec, prec = (trained_host[k] for k in ("cfg", "jax", "port"))
    model = CSNet(LayerConfig.load(cfg.AUTO.PREDEFINE), seed=0, device="cpu")
    model.load_state_dict({**model.state_dict(), **{
        k: torch.from_numpy(v) for k, v in prec["init"].items()}})
    model.double()
    opt = optim.make_adam_dwd(model, weight_decay=cfg.SOLVER.WEIGHT_DECAY,
                              decay_conv3x3_2=cfg.CUDA.WD_QUIRK)
    step = make_train_step(model, opt, flops_weight=cfg.AUTO.FLOPS.WEIGHT,
                           flops_expand=cfg.AUTO.FLOPS.EXPAND,
                           batch_size=cfg.DATA.BATCH_SIZE)
    losses, moments = [], []
    for batch, lr, penalty_on in prec["calls"]:
        m = step({k: torch.from_numpy(v).double() for k, v in batch.items()},
                 lr, penalty_on)
        losses.append(float(m["loss"]))
        moments.append(_torch_moment(model, opt))
    assert len(losses) == 2
    assert max(_per_kind(moments[0], prec["moments"][0]).values()) < 1e-3
    assert max(_per_kind(moments[0], jrec["moments"][0]).values()) < 0.1
    assert prec["losses"][1][0] == pytest.approx(losses[1], rel=1e-4)
    assert jrec["losses"][1][0] == pytest.approx(losses[1], rel=LOSS2_REL)
    init = prec["init"]
    replay = _numpy_sd(model.state_dict())
    got = _state(trained_host["port_ckpt"])
    assert max(_per_kind({k: replay[k] - v for k, v in init.items()},
                         {k: got[k] - v for k, v in init.items()}
                         ).values()) < 0.05


CONTROLS = {"lr_half": ("SOLVER.LR", 5e-5),
            "no_penalty": ("AUTO.FLOPS.ENABLE", False),
            "no_decay": ("SOLVER.WEIGHT_DECAY", 0.0)}


@pytest.mark.parametrize("control", list(CONTROLS))
def test_train_bars_see_a_wrong_update(trained_host, tmp_path, monkeypatch,
                                       control):
    """Controls of the bars above: the port's driver from the same init with
    half the learning rate, without the penalty or without weight decay
    reads at least twice a bar (a run that never steps reads 1.0 on
    both)."""
    cfg = trained_host["cfg"].clone()
    cfg.DATA.SAVEDIR = str(tmp_path)
    _set(cfg, dict([CONTROLS[control]]))
    rec = {"losses": []}
    monkeypatch.setattr(ctrain, "make_train_step",
                        _recording(ctrain.make_train_step, rec))
    out = ctrain.run_training(cfg, max_epochs=1, log=_quiet, device="cpu")
    step1, run = _readings(
        trained_host["jax"], rec, _state(trained_host["jax_ckpt"]),
        _state(os.path.join(out["dirs"]["checkpoint"],
                            "checkpoint_epoch1.pth.tar")))
    assert max(max(step1.values()) / STEP1_REL,
               max(run.values()) / RUN_REL) > 2.0


def test_train_resumes_from_either_package(trained_hybrid, tmp_path):
    """From the port's checkpoint the optimizer resumes too; from the JAX
    package's (an optax tree) the model resumes, the optimizer starts
    fresh, and the log says so."""
    trained = trained_hybrid
    for src, fresh in ((trained["port_ckpt"], False),
                       (trained["jax_ckpt"], True)):
        cfg = trained["cfg"].clone()
        cfg.DATA.SAVEDIR = str(tmp_path / f"resume_{fresh}")
        cfg.DATA.RESUME = src
        log = _Log()
        out = ctrain.run_training(cfg, max_epochs=2, log=log, device="cpu")
        assert [h["epoch"] for h in out["history"]] == [2]
        assert os.path.isfile(os.path.join(out["dirs"]["checkpoint"],
                                           "checkpoint_epoch2.pth.tar"))
        assert any("starts fresh" in m for m in log) == fresh
    # plain Adam (one param group) cannot take Adam-dwd's state (two)
    cfg.SOLVER.METHOD = "Adam"
    cfg.DATA.RESUME = trained["port_ckpt"]
    log = _Log()
    out = ctrain.run_training(cfg, max_epochs=2, log=log, device="cpu")
    assert [h["epoch"] for h in out["history"]] == [2]
    assert any("incompatible" in m and "starts fresh" in m for m in log)
    cfg.DATA.RESUME = str(tmp_path)  # a directory: the JAX package's Orbax
    with pytest.raises(SystemExit, match="Orbax"):
        ctrain.run_training(cfg, max_epochs=3, log=_Log(), device="cpu")


def test_finetune_prunes_alike_and_matches(trained_hybrid, tmp_path,
                                          monkeypatch):
    """Both drivers prune the port's checkpoint_epoch1 (the same file) at
    the smallest layer median of |gamma| (every layer keeps channels, some
    go) to the same layer_config file, then one finetune epoch lands
    within the train bar."""
    from sod100k_tpu_torch.prune import layer_gammas

    import cli.finetune as jfinetune
    from sod100k_tpu_torch.cli import finetune as cfinetune

    trained = trained_hybrid
    sd = torch.load(trained["port_ckpt"], weights_only=False)["state_dict"]
    thres = min(float(np.sort(np.abs(g))[len(g) // 2]) for g in layer_gammas(
        sd, LayerConfig.load(trained["cfg"].AUTO.PREDEFINE)))
    outs, recs = {}, {"jax": {"losses": []}, "port": {"losses": []}}
    for mod, name in ((jfinetune, "jax"), (cfinetune, "port")):
        monkeypatch.setattr(mod, "make_train_step",
                            _recording(mod.make_train_step, recs[name]))
    for name in ("jax", "port"):
        cfg = (trained["jcfg"] if name == "jax" else trained["cfg"]).clone()
        cfg.DATA.SAVEDIR = str(tmp_path / name)
        base = tmp_path / name / cfg.TASK
        shutil.copytree(os.path.dirname(os.path.dirname(trained["port_ckpt"])),
                        base)
        # the periodic test dumps of the port (eval mode: no state moves)
        cfg.TEST.ENABLE = name == "port"
        cfg.TEST.BEGIN = cfg.TEST.INTERVAL = 1
        cfg.FINETUNE.THRES = thres
        if name == "jax":
            outs[name] = jfinetune.run_finetune(cfg, from_epoch=1,
                                                max_epochs=1, log=_quiet)
        else:
            outs[name] = cfinetune.run_finetune(
                cfg, from_epoch=1, max_epochs=1, log=_quiet, device="cpu")
    lcs = [tmp_path / n / "run" / "layer_configs"
           / "layer_config_finetune_1.bin" for n in ("jax", "port")]
    assert LayerConfig.load(str(lcs[0])) == LayerConfig.load(str(lcs[1]))
    assert lcs[0].read_bytes() == lcs[1].read_bytes()
    full = LayerConfig.load(trained["cfg"].AUTO.PREDEFINE)
    assert LayerConfig.load(str(lcs[1])) != full  # channels went
    dumps = tmp_path / "port" / "run" / "finetune_ECSSD_1"
    assert len(os.listdir(dumps)) == 4
    assert len(recs["jax"]["losses"]) == len(recs["port"]["losses"]) == 2
    _changes_close(recs["jax"], recs["port"],
                   *(_state(os.path.join(outs[n]["ft_dir"],
                                         "checkpoint_epoch1.pth.tar"))
                     for n in ("jax", "port")))
    ((jl1, _), (jl2, _)), ((l1, _), (l2, _)) = (recs[n]["losses"]
                                                for n in ("jax", "port"))
    assert l1 == pytest.approx(jl1, rel=1e-4)
    assert l2 == pytest.approx(jl2, rel=LOSS2_REL)


def test_train_device_and_resident_modes_with_a_trace(trained_host,
                                                      tmp_path):
    """The device and resident front-ends of the port's driver (no JAX
    counterpart on the same draws: the augmentation keys differ), the
    resident validation and a CUDA.PROFILE_DIR trace."""
    for mode in ("device", "resident"):
        cfg = trained_host["cfg"].clone()
        cfg.DATA.SAVEDIR = str(tmp_path / mode)
        cfg.CUDA.PREPROCESS = mode
        cfg.CUDA.RESIDENT_STORE_HW = 72
        cfg.CUDA.PROFILE_DIR = str(tmp_path / mode / "trace")
        cfg.CUDA.PROFILE_STEPS = 1
        out = ctrain.run_training(cfg, max_epochs=1, log=_quiet,
                                  device="cpu")
        assert np.isfinite(out["history"][0]["loss"])
        assert 0.0 < out["best_mae"] < 1.0 and out["best_epoch"] == 1
        assert len(os.listdir(cfg.CUDA.PROFILE_DIR)) == 1


# --- test -----------------------------------------------------------------


def _maps(sal_dir):
    return {n: read_image(os.path.join(sal_dir, n))
            for n in sorted(os.listdir(sal_dir))}


def _within_one_level(want: dict, got: dict) -> None:
    assert want.keys() == got.keys() and want
    for n, w in want.items():
        assert got[n].shape == w.shape and got[n].dtype == np.uint8, n
        diff = np.abs(got[n].astype(int) - w.astype(int)).max()
        assert diff <= 1, (n, diff)
        assert w.std() > 0, n  # not a constant map


TEST_MODES = {
    "fixed": {},
    "hybrid": {"PREPROCESS": "hybrid"},
    "ceil16": {"TEST.IMAGE_H": 0, "TEST.IMAGE_W": 0},
    "ceil16_batched": {"TEST.IMAGE_H": 0, "TEST.IMAGE_W": 0,
                       "TEST.BATCH": 2},
}


@pytest.fixture(scope="module")
def tested(tree, shared, tmp_path_factory):
    """Each test mode: the JAX driver on the port's checkpoint, the port's
    driver on the JAX package's file and on its own."""
    import cli.test as jtest

    out = {}
    for mode, values in TEST_MODES.items():
        save = tmp_path_factory.mktemp(f"test_{mode}")
        front = values.get("PREPROCESS")
        jcfg, cfg = _cfgs(tree, shared, save / "jax", "t",
                          {"TEST_PREPROCESS": front} if front else None)
        values = {k: v for k, v in values.items() if k != "PREPROCESS"}
        _set(jcfg, values)
        _set(cfg, values)
        jcfg.TEST.CHECKPOINT = shared["calib"]
        jres = jtest.run_test(jcfg, log=_quiet)
        dirs = {"jax": jres["datasets"]["ECSSD"]["sal_dir"]}
        for name, ck in (("port", shared["calib"]),
                         ("port_from_jax", shared["calib_jax"])):
            c = cfg.clone()
            c.DATA.SAVEDIR = str(save / name)
            c.TEST.CHECKPOINT = ck
            res = ctest.run_test(c, log=_quiet, device="cpu")
            assert res["epoch"] == jres["epoch"] == 5
            dirs[name] = res["datasets"]["ECSSD"]["sal_dir"]
        out[mode] = {k: _maps(v) for k, v in dirs.items()}
        out[mode]["dirs"] = dirs
    return out


@pytest.mark.parametrize("mode", list(TEST_MODES))
def test_test_maps_match_the_jax_driver(tested, mode):
    maps = tested[mode]
    _within_one_level(maps["jax"], maps["port"])
    # the port reads the JAX package's file as its own: the same maps
    for n, m in maps["port"].items():
        np.testing.assert_array_equal(maps["port_from_jax"][n], m)
    assert os.path.basename(tested[mode]["dirs"]["port"]) == "ECSSD_5"
    for n, m in maps["port"].items():  # native sizes
        assert m.shape == cv2.imread(
            os.path.join(tested[mode]["dirs"]["jax"], n),
            cv2.IMREAD_GRAYSCALE).shape


def test_test_batched_within_a_level_of_per_image(tested):
    """Torch's CPU convolutions change their arithmetic with the batch
    size (f32 on the card does not), so a map may move by one level."""
    _within_one_level(tested["ceil16"]["port"],
                      tested["ceil16_batched"]["port"])


def test_test_notes_a_dropped_batch(tree, shared, tested, tmp_path):
    """TEST.BATCH > 1 on a fixed-size config logs once that it does not
    apply and changes no map (here with the device front-end, whose JAX
    counterpart draws are held in tests/test_torch_data.py)."""
    _, cfg = _cfgs(tree, shared, tmp_path, "t", {"TEST_PREPROCESS": "device"})
    cfg.TEST.CHECKPOINT = shared["calib"]
    cfg.TEST.BATCH = 3
    log = _Log()
    res = ctest.run_test(cfg, log=log, device="cpu")
    assert sum("TEST.BATCH=3 applies" in m for m in log) == 1
    maps = _maps(res["datasets"]["ECSSD"]["sal_dir"])
    assert maps.keys() == tested["fixed"]["port"].keys()
    for n, m in maps.items():
        assert m.shape == tested["fixed"]["port"][n].shape and m.std() > 0
    cfg.TEST.BATCH = 1
    log = _Log()
    ctest.run_test(cfg, log=log, device="cpu")
    assert not any("TEST.BATCH" in m for m in log)


# --- export and serve -----------------------------------------------------


def _config_file(tmp_path, shared) -> str:
    path = tmp_path / "serve.yml"
    path.write_text(f"TEST:\n  MODEL_CONFIG: {shared['predefine']}\n"
                    f"  CHECKPOINT: '{shared['calib']}'\n"
                    f"  IMAGE_H: {HW}\n  IMAGE_W: {HW}\nGPU: 0\n")
    return str(path)


def test_export_artifact_equals_the_eval_step(shared, tmp_path):
    out = cexport.run_export(Namespace(
        config=_config_file(tmp_path, shared), family="csnet", model=None,
        arch="res2net50", size=336, out=str(tmp_path / "art"), batch="1,2",
        dtype="f32", wire="u8"), device="cpu")
    sm = load_artifact(out, device="cpu")
    assert sm.batches == [1, 2] and sm.meta["wire"] == "u8"
    model = CSNet(init_layers(8, SPLIT), device="cpu")
    model.load_state_dict(torch.load(shared["calib"], weights_only=False)
                          ["state_dict"])
    step = make_eval_step(model, from_u8=True, quantize_u8=True)
    x = np.random.default_rng(0).integers(0, 256, (2, HW, HW, 3), np.uint8)
    for n in (1, 2):  # one bucket each: the same forward
        np.testing.assert_array_equal(
            sm(x[:n]), step(torch.from_numpy(x[:n])).numpy())


def test_export_of_a_csf_checkpoint(tmp_path):
    """--family csf: the seeded CSF model under the checkpoint's tensors
    (a partial file here), exported with its backbone's name."""
    import json

    from sod100k_tpu_torch.arch.csf_res2net import CSFNet

    donor = CSFNet("res2net50", seed=3, device="cpu")
    part = {k: v for k, v in donor.state_dict().items()
            if k.startswith("fuse1x1.")}
    torch.save({"state_dict": part}, tmp_path / "csf.pth")
    out = cexport.run_export(Namespace(
        config=None, family="csf", model=str(tmp_path / "csf.pth"),
        arch="res2net50", size=96, out=str(tmp_path / "art"), batch="1",
        dtype="bf16", wire="u8"), device="cpu")
    meta = json.loads(open(os.path.join(out, "meta.json")).read())
    assert (meta["family"], meta["backbone"], meta["h"], meta["w"],
            meta["compute_dtype"]) == ("csf", "res2net50", 96, 96,
                                       "bfloat16")
    saved = torch.load(os.path.join(out, "model.pt"), weights_only=True)
    for k, v in part.items():
        assert torch.equal(saved[k], v), k


def test_serve_main_answers_healthz_and_predict(shared, tmp_path,
                                                monkeypatch):
    import io
    import json

    art = cexport.run_export(Namespace(
        config=_config_file(tmp_path, shared), family="csnet", model=None,
        arch="res2net50", size=336, out=str(tmp_path / "art"), batch="1,4",
        dtype="f32", wire="f32"), device="cpu")
    real_load, real_make = cserve.load_artifact, cserve.make_server
    seen = {}

    def make_server(*a, **k):
        srv = real_make(*a, **k)

        def client():
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                    seen["healthz"] = (r.status, json.loads(r.read()))
                buf = io.BytesIO()
                x = np.random.default_rng(1).standard_normal(
                    (HW, HW, 3)).astype(np.float32)
                np.save(buf, x)
                req = urllib.request.Request(
                    url + "/predict", data=buf.getvalue(), method="POST",
                    headers={"Content-Type": "application/x-npy"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    seen["predict"] = (x, np.load(io.BytesIO(r.read())))
                # an encoded image in, a PNG map out, without cv2
                img = np.random.default_rng(2).integers(
                    0, 256, (50, 70, 3), np.uint8)
                req = urllib.request.Request(
                    url + "/predict", data=encode_png(img), method="POST",
                    headers={"Content-Type": "image/png"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    seen["png"] = (img, decode_png(r.read()))
            finally:
                srv.shutdown()

        threading.Thread(target=client, daemon=True).start()
        return srv

    monkeypatch.setattr(cserve, "load_artifact",
                        lambda p, device, mesh_devices=None: real_load(
                            p, device="cpu", mesh_devices=mesh_devices))
    monkeypatch.setattr(cserve, "make_server", make_server)
    cserve.main(["--artifact", art, "--port", "0"])
    assert seen["healthz"][0] == 200
    x, y = seen["predict"]
    want = load_artifact(art, device="cpu")(x[None])[0]
    assert y.shape == (HW, HW, 1)
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-6)
    img, png = seen["png"]
    x = (resize_u8_linear(img, (HW, HW)) / np.float32(255.0)
         - IMAGENET_MEAN) / IMAGENET_STD
    want = load_artifact(art, device="cpu")(x[None].astype(np.float32))[0]
    np.testing.assert_array_equal(
        png, np.trunc(want[..., 0] * 255.0).astype(np.uint8))


def test_drivers_print_the_counter_of_their_flops(trained_host, tmp_path):
    """The startup FLOPs line names the counter that made the number."""
    log = _Log()
    dirs = dict(trained_host["out"]["dirs"])
    for k in ("checkpoint", "layer_configs"):
        dirs[k] = str(tmp_path)
    ctrain.build_model_from_cfg(trained_host["cfg"], dirs, log, device="cpu")
    assert any("FLOPs" in m and "torch.utils.flop_counter" in m for m in log)


DRIVERS = ("train", "finetune", "test", "eval", "export", "serve", "smoke")


@pytest.fixture(scope="module")
def helps():
    """Each driver's --help, in one subprocess where jax, the JAX package,
    yaml, cv2 and PIL are unimportable (the machine with the card has none
    of them): {driver: exit code}."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, io, contextlib, runpy\n"
        "for m in ('jax', 'sod100k_tpu', 'cv2', 'PIL', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        f"for name in {DRIVERS!r}:\n"
        "    sys.argv = [name, '--help']\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(io.StringIO()):\n"
        "            runpy.run_module('sod100k_tpu_torch.cli.' + name,\n"
        "                             run_name='__main__')\n"
        "        rc = 'returned'\n"
        "    except SystemExit as e:\n"
        "        rc = e.code\n"
        "    print(name, rc)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": repo})
    assert out.returncode == 0, out.stderr
    return dict(line.split() for line in out.stdout.splitlines())


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_help_without_jax_yaml_cv2_or_pil(helps, name):
    assert helps[name] == "0"
