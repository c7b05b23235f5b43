"""The port's main CLI (keymorph_tpu_torch/cli/run.py) end to end on the
CPU, on the tiny synthetic NIfTI dataset of tests/test_cli.py (five 12^3
subjects, two modalities, train and test rows in a CSV): train, pretrain,
the weights-only handoff, resume, eval, and the files and keys
keymorph_tpu's ``cli/run.py`` writes (``args.json``,
``checkpoints/epoch{N}_model``, ``train_log.jsonl``,
``eval/summary_{unimodal,multimodal}.json``). keymorph_tpu's own CLI is
slow-marked (its steps compile); its key sets are taken from its code
(``Config``'s fields, ``_build_metric_dict``) and its argument parser runs
on the same command lines.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from keymorph_tpu.cli import eval_pairwise as jeval
from keymorph_tpu.cli import hyperparameters as jhp
from keymorph_tpu.cli import run as jrun
from keymorph_tpu.training import config as jconfig
from keymorph_tpu_torch.cli import run
from keymorph_tpu_torch.data import save_nifti

TRAIN_LOG_KEYS = {"epoch", "mse", "loss", "grad_norm", "epoch_time", "steps_per_sec"}
PRETRAIN_LOG_KEYS = {"epoch", "mse", "loss", "epoch_time"}
# the flagship family at a CPU size: bf16 TruncatedUNet3D (f_maps 32), 3 levels
FLAGSHIP = ["--backbone", "truncatedunet", "--use_amp", "--num_levels_for_unet", "3",
            "--img_size", "16", "16", "16"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    """tests/test_cli.py's dataset: four training subjects (T1, T1, T2; the
    fourth row's T1 and T2 are test subjects) with 3-label segmentations."""
    root = tmp_path_factory.mktemp("tiny_data")
    rng = np.random.default_rng(0)
    rows = []
    for i, (mod, train) in enumerate(
            [("T1", True), ("T1", True), ("T2", True), ("T1", False), ("T2", False)]):
        img = rng.uniform(0, 1, size=(12, 12, 12)).astype(np.float32)
        seg = rng.integers(0, 3, size=(12, 12, 12)).astype(np.int16)
        save_nifti(str(root / f"img{i}.nii.gz"), img)
        save_nifti(str(root / f"seg{i}.nii.gz"), seg)
        rows.append(f"{root / f'img{i}.nii.gz'},{root / f'seg{i}.nii.gz'},None,{mod},{train}")
    csv_path = root / "data.csv"
    csv_path.write_text("img_path,seg_path,mask_path,modality,train\n" + "\n".join(rows) + "\n")
    return str(csv_path)


def _args(csv_path, save_dir, *extra):
    return ["--num_keypoints", "8", "--data_path", csv_path, "--train_dataset", "csv",
            "--save_dir", str(save_dir), "--lr", "1e-4", "--log_interval", "1",
            "--device", "cpu", *extra]


def _log(model_dir):
    with open(os.path.join(model_dir, "train_log.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def _payload(model_dir, epoch):
    return torch.load(os.path.join(model_dir, "checkpoints", f"epoch{epoch}_model",
                                   "checkpoint.pt"), weights_only=True)


def test_parse_args_matches_jax():
    """The same command line gives the same Config in both packages (the
    ``--no_<flag>`` switch of a True-default bool, tuples, optional ints);
    ``--device`` is the port's own."""
    argv = ["--run_mode", "pretrain", "--no_save_eval_artifacts", "--img_size", "8", "9", "10",
            "--max_random_affine_augment_params", "0.1", "0.2", "0.3", "0.4",
            "--max_train_keypoints", "16", "--use_amp", "--backbone", "residualunetse"]
    config, device = run.parse_args(argv + ["--device", "cpu"])
    assert device == "cpu" and config.save_eval_artifacts is False
    assert dataclasses.asdict(config) == dataclasses.asdict(jrun.parse_args(argv))
    assert run.parse_args([])[1] is None


def test_run_cli_train_debug_default_conv(tiny_dataset, tmp_path):
    """keymorph_tpu's defaults (the fp32 ConvNet, affine, MSE) train 2 debug
    epochs of 3 steps: args.json with keymorph_tpu's Config fields, a
    checkpoint per epoch (log_interval 1) with keymorph_tpu's payload keys,
    train_log.jsonl with its keys."""
    run.main(_args(tiny_dataset, tmp_path, "--run_mode", "train", "--debug_mode",
                   "--img_size", "32", "32", "32"))
    model_dir = tmp_path / "keymorph"
    with open(model_dir / "args.json") as fh:
        saved = json.load(fh)
    assert set(saved) == {f.name for f in dataclasses.fields(jconfig.Config)}
    assert saved["backbone"] == "conv" and saved["use_amp"] is False
    assert sorted(os.listdir(model_dir / "checkpoints")) == ["epoch1_model", "epoch2_model"]
    payload = _payload(model_dir, 2)
    assert set(payload) == {"params", "opt_state", "step", "epoch"}
    assert payload["step"] == 6 and payload["epoch"] == 2
    assert any(k.startswith("backbone.block9.") for k in payload["params"])
    log = _log(model_dir)
    assert [r["epoch"] for r in log] == [1, 2]
    assert all(set(r) == TRAIN_LOG_KEYS and np.isfinite(r["loss"]) for r in log)


def test_run_cli_pretrain_then_weights_only_handoff(tiny_dataset, tmp_path):
    """Pretraining the flagship family writes checkpoints that carry the
    reference keypoints; ``--load_weights_only`` hands its parameters to a
    same-resolution TPS training run with a fresh optimizer (Adam's step
    count restarts) and no ``ref_points``."""
    run.main(_args(tiny_dataset, tmp_path, "--run_mode", "pretrain", "--debug_mode",
                   "--job_name", "pre", *FLAGSHIP))
    pre = _payload(tmp_path / "pre", 2)
    assert set(pre) == {"params", "opt_state", "step", "epoch", "ref_points"}
    assert pre["ref_points"].shape == (1, 8, 3) and pre["step"] == 6
    assert float(pre["ref_points"].abs().max()) <= 1.0
    log = _log(tmp_path / "pre")
    assert [r["epoch"] for r in log] == [1, 2] and all(set(r) == PRETRAIN_LOG_KEYS for r in log)

    ckpt = str(tmp_path / "pre" / "checkpoints" / "epoch2_model")
    run.main(_args(tiny_dataset, tmp_path, "--run_mode", "train", "--debug_mode",
                   "--job_name", "handoff", "--load_path", ckpt, "--load_weights_only",
                   "--transform_type", "tps_loguniform", "--train_same_resolution", *FLAGSHIP))
    post = _payload(tmp_path / "handoff", 2)
    assert set(post) == {"params", "opt_state", "step", "epoch"}
    assert post["step"] == 6 and post["epoch"] == 2  # fresh: 2 epochs x 3 steps from 0
    assert all(float(s["step"]) == 6 for s in post["opt_state"]["state"].values())
    moved = [k for k in pre["params"] if not torch.equal(pre["params"][k], post["params"][k])]
    assert moved  # trained on from the pretrained weights
    assert all(set(r) == TRAIN_LOG_KEYS for r in _log(tmp_path / "handoff"))


def test_run_cli_resume_latest(tiny_dataset, tmp_path):
    """``--resume_latest`` continues at the newest checkpoint's epoch + 1 with
    its optimizer state and step count (training), and a resumed pretraining
    reuses the checkpoint's reference keypoints."""
    base = _args(tiny_dataset, tmp_path, "--steps_per_epoch", "2", *FLAGSHIP)
    run.main(base + ["--run_mode", "train", "--epochs", "1"])
    run.main(base + ["--run_mode", "train", "--epochs", "2", "--resume_latest"])
    model_dir = tmp_path / "keymorph"
    assert [r["epoch"] for r in _log(model_dir)] == [1, 2]
    p2 = _payload(model_dir, 2)
    assert p2["step"] == 4 and p2["epoch"] == 2
    assert all(float(s["step"]) == 4 for s in p2["opt_state"]["state"].values())

    pre = base + ["--run_mode", "pretrain", "--job_name", "pre"]
    run.main(pre + ["--epochs", "1"])
    run.main(pre + ["--epochs", "2", "--resume_latest"])
    a, b = _payload(tmp_path / "pre", 1), _payload(tmp_path / "pre", 2)
    assert b["step"] == 4 and torch.equal(a["ref_points"], b["ref_points"])


def test_run_cli_eval_writes_keymorph_tpu_summaries(tiny_dataset, tmp_path):
    """Eval in debug mode from a trained checkpoint: both suites' summaries
    with keymorph_tpu's keys (every metric of a dataset with segmentations,
    rot0, affine, each suite's modality pairs), a value where the test split
    has the pair (T1:T1; debug mode stops after one subject a suite) and
    null where it has none (PD)."""
    args = _args(tiny_dataset, tmp_path, *FLAGSHIP)
    run.main(args + ["--run_mode", "train", "--debug_mode"])
    run.main(args + ["--run_mode", "eval", "--debug_mode", "--load_path",
                     str(tmp_path / "keymorph" / "checkpoints" / "epoch2_model")])
    eval_dir = tmp_path / "keymorph" / "eval"
    for suite, names in (("unimodal", jhp.EVAL_UNI_NAMES), ("multimodal", jhp.EVAL_MULTI_NAMES)):
        with open(eval_dir / f"summary_{suite}.json") as fh:
            summary = json.load(fh)
        assert set(summary) == set(jeval._build_metric_dict(jhp.EVAL_METRICS, ["rot0"],
                                                            ["affine"], names))
        assert all(v is None for k, v in summary.items() if ":PD:" in k)
    with open(eval_dir / "summary_unimodal.json") as fh:
        summary = json.load(fh)
    assert all(np.isfinite(summary[f"{m}:T1:T1:rot0:affine"]) for m in jhp.EVAL_METRICS)
    assert (eval_dir / "eval_unimodal").is_dir()


def test_run_cli_refuses_what_is_not_ported(tiny_dataset, tmp_path, monkeypatch, capsys):
    """Both flags are ported. ``--visualize`` renders keymorph_tpu's panels
    of a training batch at epochs 1 and 2 (every ``log_interval``-th and the
    last; with the dice loss also the segmentations); ``--use_wandb``
    without wandb prints keymorph_tpu's fallback line and trains on."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # the import raises ImportError
    run.main(_args(tiny_dataset, tmp_path / "viz", *FLAGSHIP, "--run_mode", "train",
                   "--debug_mode", "--visualize", "--loss_fn", "dice"))
    assert sorted(os.listdir(tmp_path / "viz" / "keymorph" / "img")) == [
        "img_epoch1.png", "img_epoch2.png", "seg_epoch1.png", "seg_epoch2.png"]
    run.main(_args(tiny_dataset, tmp_path / "wandb", *FLAGSHIP, "--run_mode", "train",
                   "--debug_mode", "--use_wandb"))
    assert "wandb not available; logging to stdout only" in capsys.readouterr().out
    assert [r["epoch"] for r in _log(tmp_path / "wandb" / "keymorph")] == [1, 2]
