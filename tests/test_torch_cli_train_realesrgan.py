"""``python -m srganfd_tpu_torch.cli.train --config realesrnet`` and
``--config realesrgan`` on the CPU: for each config a straight run of 2
epochs against the same run cut after its first epoch and resumed (the
Real-ESRGAN chain's draws are keyed by the step, so the resumed run sees
the same batches), the command line with ``--resume auto``, and the
trainer's separate pixel target. Seeded synthetic frames of 72 x 72; G at
``--tiny`` widths (8 channels, growth 4, 1 RRDB), D at 8 channels through
``run_train``; GT 64 at x4, so that every stage of the chain stays above
the K = 21 kernels' reflect pad."""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from srganfd_tpu_torch import configs
from srganfd_tpu_torch.cli import train as cli_train
from srganfd_tpu_torch.convert import load_generator_weights
from srganfd_tpu_torch.track import tracker
from srganfd_tpu_torch.train import checkpoint as ckpt
from srganfd_tpu_torch.train.loop import Trainer
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TINY_G = {"channels": 8, "growth_channels": 4, "num_rrdb": 1}
EXP = {"realesrnet": "RealESRNet_x4", "realesrgan": "RealESRGAN_x4"}


@pytest.fixture(autouse=True)
def _jsonl_only(monkeypatch):
    """The tests read the tracker's JSONL; the TensorBoard sink, where it is
    installed, would only add an import of TensorFlow."""
    monkeypatch.setattr(tracker, "_optional_summary_writer", lambda: None)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:72, 0:72] / 72
    for i in range(4):
        base = 0.5 + 0.3 * np.sin(2 * np.pi * (xx * (i + 1) + yy * rng.uniform(0.5, 2))) + 0.1 * (xx > 0.5)
        img = np.clip(base[..., None] + 0.05 * rng.standard_normal((72, 72, 3)), 0, 1)
        cv2.imwrite(os.path.join(d, f"frame_{i}.png"), (img * 255).astype(np.uint8))
    return str(d)


def _cfg(name, frames, root, epochs):
    kw = {"d_kwargs": {"channels": 8}} if name == "realesrgan" else {}
    return configs.get_config(
        name, train_gt_images_dir=frames, valid_gt_images_dir=frames, gt_image_size=64, batch_size=2,
        epochs=epochs, num_workers=1, g_kwargs=TINY_G, results_dir=os.path.join(root, "results"),
        samples_dir=os.path.join(root, "samples"), **kw,
    )


def _assert_same(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}/{i}")
    else:
        assert a == b, where


class _Stop(Exception):
    pass


@pytest.mark.parametrize("name", ["realesrnet", "realesrgan"])
def test_resume_continues_the_straight_run(name, frames, tmp_path, monkeypatch):
    """Two epochs of 2 steps straight, and the same run stopped at the
    first step of epoch 1 and resumed: the last checkpoints are equal bit
    for bit (G, EMA-G, Adam(s), D and its ``u`` for the GAN, step, best
    metrics); the selection metric is the config's (PSNR, LPIPS)."""
    straight = str(tmp_path / "straight")
    result = cli_train.run_train(_cfg(name, frames, straight, 2), steps_per_epoch=2, device="cpu")

    cut = str(tmp_path / "cut")
    real_step, calls = Trainer.train_step, {"n": 0}

    def stop_at_third(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise _Stop
        return real_step(self, *a, **kw)

    monkeypatch.setattr(Trainer, "train_step", stop_at_third)
    with pytest.raises(_Stop):
        cli_train.run_train(_cfg(name, frames, cut, 2), steps_per_epoch=2, device="cpu")
    monkeypatch.setattr(Trainer, "train_step", real_step)
    cli_train.run_train(_cfg(name, frames, cut, 2), steps_per_epoch=2, resume="auto", device="cpu")

    want = ckpt.load_checkpoint(os.path.join(straight, "results", EXP[name], "ckpt_last.pth"))
    got = ckpt.load_checkpoint(os.path.join(cut, "results", EXP[name], "ckpt_last.pth"))
    assert want["step"] == 4 and want["epoch"] == 1
    assert ("d_state_dict" in want) == (name == "realesrgan")
    _assert_same(got, want)
    assert want["state_dict"]["conv1.weight"].shape == (8, 3, 3, 3)

    with open(os.path.join(straight, "samples", "logs", EXP[name], "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    metric = "Valid/LPIPS" if name == "realesrgan" else "Valid/PSNR"
    scores = [e["metrics"][metric] for e in events if e["type"] == "metrics" and metric in e["metrics"]]
    assert len(scores) == 2 and all(np.isfinite(scores))
    best = ckpt.load_checkpoint(os.path.join(straight, "results", EXP[name], "ckpt_best.pth"))
    pick = np.argmin if name == "realesrgan" else np.argmax
    assert best["epoch"] == int(pick(scores))
    train = [e["metrics"] for e in events if e["type"] == "metrics" and "Train/g_loss" in e["metrics"]]
    parts = {"pixel_loss"} | ({"content_loss", "adversarial_loss", "d_loss"} if name == "realesrgan" else set())
    assert train and {f"Train/{k}" for k in parts} <= set(train[0])
    assert np.isfinite(result["best_psnr"])


def test_cli_trains_realesrgan_tiny_and_resumes(frames, tmp_path, monkeypatch, capsys):
    """The command line: ``--tiny`` shrinks G only (D keeps 64 channels);
    a second call with ``--resume auto`` and one more epoch starts at the
    checkpoint's step; the checkpoint serves G and EMA-G."""
    monkeypatch.chdir(tmp_path)  # results/ and samples/ are relative
    argv = ["--config", "realesrgan", "--device-type", "cpu", "--tiny", "--train-dir", frames,
            "--valid-dir", frames, "--gt-size", "64", "--batch-size", "2", "--steps-per-epoch", "1"]
    cli_train.main([*argv, "--epochs", "1"])
    cli_train.main([*argv, "--epochs", "2", "--resume", "auto"])
    assert "at step 1 (epoch 1)" in capsys.readouterr().out
    path = os.path.join(tmp_path, "results", "RealESRGAN_x4", "ckpt_last.pth")
    payload = ckpt.load_checkpoint(path)
    assert payload["step"] == 2 and payload["epoch"] == 1
    assert payload["d_state_dict"]["conv1.weight"].shape == (128, 64, 4, 4)
    assert payload["state_dict"]["conv1.weight"].shape == (8, 3, 3, 3)
    assert set(load_generator_weights(path, use_ema=True)) == set(payload["state_dict"])


def test_the_pixel_loss_targets_gt_pixel():
    """``realesrnet``'s L1 is taken against ``gt_pixel`` when the batch
    carries it (the USM-sharpened GT), against ``gt`` when not."""
    cfg = configs.get_config("realesrnet", g_kwargs=TINY_G)
    g = torch.Generator().manual_seed(0)
    gt, pixel, lr = torch.rand(2, 16, 16, 3, generator=g), torch.rand(2, 16, 16, 3, generator=g), torch.rand(
        2, 4, 4, 3, generator=g)
    losses = []
    for target in (None, pixel):
        tr = Trainer(cfg)
        st = tr.init_state()
        with torch.no_grad():
            sr = st.g_model(lr)
        want = (sr - (gt if target is None else target)).abs().mean()
        losses.append(float(tr.train_step(st, gt, lr, target)["pixel_loss"]))
        assert abs(losses[-1] - float(want)) < 1e-7
    assert losses[0] != losses[1]
