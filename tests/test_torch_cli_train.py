"""``python -m srganfd_tpu_torch.cli.train --config bsrnet`` on the CPU:
checkpoints, a step-exact ``--resume auto``, and ``cli.infer`` serving
what the trainer wrote. Seeded synthetic frames; ``--tiny`` widths except
where ``cli.infer`` (full-width ``bsrgan_x2``) reads the checkpoint."""

import os

import cv2
import numpy as np
import pytest
import torch

from srganfd_tpu_torch.cli import infer
from srganfd_tpu_torch.cli import train as cli_train
from srganfd_tpu_torch.convert import load_generator_weights
from srganfd_tpu_torch.track import tracker
from srganfd_tpu_torch.train import checkpoint as ckpt
from srganfd_tpu_torch.train.loop import Trainer
from torch_threads import few_torch_threads  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _jsonl_only(monkeypatch):
    """The tracker's TensorBoard sink, where it is installed, would only add
    an import of TensorFlow to these runs."""
    monkeypatch.setattr(tracker, "_optional_summary_writer", lambda: None)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:48, 0:48] / 48
    for i in range(8):
        base = 0.5 + 0.3 * np.sin(2 * np.pi * (xx * (i + 1) + yy * rng.uniform(0.5, 2)))
        img = np.clip(base[..., None] + 0.1 * rng.standard_normal((48, 48, 3)), 0, 1)
        cv2.imwrite(os.path.join(d, f"frame_{i}.png"), (img * 255).astype(np.uint8))
    return str(d)


def _args(frames, *extra):
    return ["--config", "bsrnet", "--device-type", "cpu", "--train-dir", frames,
            "--valid-dir", frames, "--gt-size", "24", "--batch-size", "2",
            "--steps-per-epoch", "2", *extra]


def _run(monkeypatch, results, argv):
    monkeypatch.chdir(results)  # results_dir is relative: results/<exp_name>
    cli_train.main(argv)
    return os.path.join(results, "results", "BSRNet_x2")


class _Stop(Exception):
    pass


def test_train_writes_checkpoints_and_resumes_step_exact(frames, tmp_path, monkeypatch):
    (tmp_path / "whole").mkdir()
    whole = _run(monkeypatch, tmp_path / "whole", _args(frames, "--tiny", "--epochs", "2"))
    for name in ("ckpt_last.pth", "ckpt_best.pth"):
        assert os.path.isfile(os.path.join(whole, name))
    last = ckpt.load_checkpoint(os.path.join(whole, "ckpt_last.pth"))
    assert (last["epoch"], last["step"]) == (1, 4)
    assert set(last) >= {"state_dict", "ema_state_dict", "optimizer", "best_psnr", "best_ssim"}

    # the same run, stopped at the first step of epoch 1 (after epoch 0's
    # checkpoints), then resumed with the same command line
    (tmp_path / "cut").mkdir()
    real_step = Trainer.train_step
    calls = {"n": 0}

    def stop_at_third(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise _Stop
        return real_step(self, *a, **kw)

    monkeypatch.setattr(Trainer, "train_step", stop_at_third)
    with pytest.raises(_Stop):
        _run(monkeypatch, tmp_path / "cut", _args(frames, "--tiny", "--epochs", "2"))
    monkeypatch.setattr(Trainer, "train_step", real_step)
    cut = os.path.join(tmp_path, "cut", "results", "BSRNet_x2")
    assert ckpt.load_checkpoint(os.path.join(cut, "ckpt_last.pth"))["step"] == 2
    _run(monkeypatch, tmp_path / "cut", _args(frames, "--tiny", "--epochs", "2", "--resume", "auto"))

    resumed = ckpt.load_checkpoint(os.path.join(cut, "ckpt_last.pth"))
    assert resumed["step"] == 4
    for key in ("state_dict", "ema_state_dict"):
        for name, want in last[key].items():
            assert torch.equal(resumed[key][name], want), (key, name)
    assert resumed["best_psnr"] == last["best_psnr"]


def test_infer_serves_the_trained_ema_generator(frames, tmp_path, monkeypatch):
    """Full-width ``bsrgan_x2``, one step: ``cli.infer --weights
    ckpt_last.pth --use-ema`` loads EMA-G and serves a frame."""
    valid = tmp_path / "valid"
    valid.mkdir()
    for name in sorted(os.listdir(frames))[:2]:
        os.link(os.path.join(frames, name), valid / name)
    argv = _args(frames, "--epochs", "1", "--steps-per-epoch", "1")
    argv[argv.index("--valid-dir") + 1] = str(valid)
    out_dir = _run(monkeypatch, tmp_path, argv)
    path = os.path.join(out_dir, "ckpt_last.pth")
    g, ema = load_generator_weights(path), load_generator_weights(path, use_ema=True)
    assert any(not torch.equal(g[k], ema[k]) for k in g)  # EMA-G is its own set

    out = tmp_path / "sr.png"
    infer.main(["--device-type", "cpu", "--model-arch", "bsrgan_x2", "--weights", path,
                "--use-ema", "--inputs-path", str(valid / sorted(os.listdir(valid))[0]),
                "--output-path", str(out)])
    assert cv2.imread(str(out)).shape == (96, 96, 3)


@pytest.mark.parametrize("flag", [
    ["--grad-accum", "2"], ["--skip-nonfinite"], ["--async-ckpt"], ["--save-every-steps", "5"],
    ["--ckpt-every-epochs", "2"],
    ["--profile-dir", "prof"], ["--debug-nans"],
], ids=lambda f: f[0].lstrip("-"))
def test_unported_flags_name_the_roadmap_item(frames, flag):
    with pytest.raises(SystemExit, match="ROADMAP.md A4"):
        cli_train.main(_args(frames, *flag))


@pytest.mark.parametrize("field,value", [
    ("grad_accum_steps", 2), ("model_weight_decay", 0.01),
])
def test_unported_config_fields_name_the_roadmap_item(frames, field, value):
    from srganfd_tpu_torch import configs

    cfg = configs.get_config("bsrnet", train_gt_images_dir=frames, valid_gt_images_dir=frames)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A4"):
        cli_train.run_train(cfg.replace(**{field: value}), device="cpu")


@pytest.mark.parametrize("var,value", [("SRGANFD_FUSE_STEP", "1"), ("SRGANFD_STEPS_PER_DISPATCH", "4")])
def test_unported_dispatch_variables_are_refused(frames, tmp_path, monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A4"):
        _run(monkeypatch, tmp_path, _args(frames, "--tiny", "--epochs", "1"))


def test_cuda_without_a_card_exits(frames, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(frames, "--tiny")
    args[args.index("--device-type") + 1] = "cuda"
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_train.main(args)
