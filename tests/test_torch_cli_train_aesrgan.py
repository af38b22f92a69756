"""``python -m srganfd_tpu_torch.cli.train --config aesrgan --tiny`` on the
CPU, against the attention-gated U-Net discriminator and, with ``--d-arch
discriminator_attention_unet_ms``, its two-scale ensemble: one step, then
``--resume auto`` for a second, the resumed state's D (its BatchNorm
running statistics and every ``u``) and its Adam exactly as the
checkpoint held them; the EMA generator of the checkpoint served through
``load_generator_weights``; and a full-width run whose checkpoint
``cli.infer`` and ``cli.serve --stdio`` serve. Seeded synthetic frames of
48 x 48; G at
``--tiny`` widths (8 channels, growth 4, 1 RRDB, 4 heads of 2), D at its
config width (64 features); GT 32 (sides of 16k, as the ensemble's two
scales need)."""

import copy
import io
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from srganfd_tpu_torch.cli import infer, serve
from srganfd_tpu_torch.cli import train as cli_train
from srganfd_tpu_torch.convert import load_generator_weights
from srganfd_tpu_torch.models import create_model
from srganfd_tpu_torch.track import tracker
from srganfd_tpu_torch.train import checkpoint as ckpt
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TINY_G = {"channels": 8, "growth_channels": 4, "num_rrdb": 1}
D_STATE = (".u", ".running_mean", ".running_var")


@pytest.fixture(autouse=True)
def _jsonl_only(monkeypatch):
    """The TensorBoard sink, where it is installed, would only add an import
    of TensorFlow."""
    monkeypatch.setattr(tracker, "_optional_summary_writer", lambda: None)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:48, 0:48] / 48
    for i in range(4):
        base = 0.5 + 0.3 * np.sin(2 * np.pi * (xx * (i + 1) + yy * rng.uniform(0.5, 2)))
        img = np.clip(base[..., None] + 0.1 * rng.standard_normal((48, 48, 3)), 0, 1)
        cv2.imwrite(os.path.join(d, f"frame_{i}.png"), (img * 255).astype(np.uint8))
    return str(d)


@pytest.mark.parametrize("d_arch", [None, "discriminator_attention_unet_ms"], ids=["attention_unet", "ensemble"])
def test_cli_trains_aesrgan_tiny_and_resumes_exactly(frames, tmp_path, monkeypatch, d_arch):
    monkeypatch.chdir(tmp_path)  # results/ and samples/ are relative
    restored = []
    real_restore = ckpt.restore_state

    def recorded_restore(state, payload):
        real_restore(state, payload)
        restored.append(({k: v.clone() for k, v in state.d_model.state_dict().items()},
                         copy.deepcopy(state.d_opt.state_dict()), payload))

    monkeypatch.setattr(ckpt, "restore_state", recorded_restore)
    argv = ["--config", "aesrgan", "--device-type", "cpu", "--tiny", "--train-dir", frames, "--valid-dir", frames,
            "--gt-size", "32", "--batch-size", "2", "--steps-per-epoch", "1", "--resume", "auto"]
    argv += ["--d-arch", d_arch] if d_arch else []
    cli_train.main(argv + ["--epochs", "1"])
    ckpt_dir = os.path.join(tmp_path, "results", "AESRGAN_x2")
    first = ckpt.load_checkpoint(os.path.join(ckpt_dir, "ckpt_last.pth"))
    cli_train.main(argv + ["--epochs", "2"])
    last = ckpt.load_checkpoint(os.path.join(ckpt_dir, "ckpt_last.pth"))

    assert first["step"] == 1 and last["step"] == 2 and len(restored) == 1
    d_sd, d_opt, payload = restored[0]
    assert payload["step"] == 1
    state_keys = [k for k in first["d_state_dict"] if k.endswith(D_STATE)]
    scales = 2 if d_arch else 1
    assert sum(k.endswith(".running_var") for k in state_keys) == 3 * scales
    assert sum(k.endswith(".u") for k in state_keys) == 12 * scales
    for k, v in first["d_state_dict"].items():
        assert torch.equal(d_sd[k], v), k
    adam = first["d_optimizer"]["state"]
    assert set(d_opt["state"]) == set(adam) and adam[0]["step"] == 1
    assert all(torch.equal(d_opt["state"][i][k], adam[i][k]) for i in adam for k in adam[i])
    # the second step moved every running statistic and u on from the checkpoint's
    assert all(not torch.equal(last["d_state_dict"][k], first["d_state_dict"][k]) for k in state_keys)

    g = create_model("bsrgantrans_x2", **TINY_G)
    g.load_state_dict(load_generator_weights(os.path.join(ckpt_dir, "ckpt_best.pth"), use_ema=True))
    with torch.no_grad():
        sr = g(torch.rand(1, 8, 10, 3, generator=torch.Generator().manual_seed(0)))
    assert sr.shape == (1, 16, 20, 3) and torch.isfinite(sr).all()


def test_infer_and_serve_the_trained_aesrgan_generator(frames, tmp_path, monkeypatch, capsys):
    """Full-width ``aesrgan`` (``bsrgantrans_x2`` 64/32/23 against the
    64-feature attention D), one step at GT 32: ``cli.infer`` and
    ``cli.serve --stdio`` with ``--model-arch bsrgantrans_x2 --weights
    ckpt_last.pth --use-ema`` load EMA-G and serve a 48 x 48 frame."""
    monkeypatch.chdir(tmp_path)
    valid = tmp_path / "valid"
    valid.mkdir()
    frame = sorted(os.listdir(frames))[0]
    os.link(os.path.join(frames, frame), valid / frame)
    cli_train.main(["--config", "aesrgan", "--device-type", "cpu", "--train-dir", frames, "--valid-dir", str(valid),
                    "--gt-size", "32", "--batch-size", "1", "--steps-per-epoch", "1", "--epochs", "1"])
    path = os.path.join(tmp_path, "results", "AESRGAN_x2", "ckpt_last.pth")
    g, ema = load_generator_weights(path), load_generator_weights(path, use_ema=True)
    assert any(not torch.equal(g[k], ema[k]) for k in g) and any(k.startswith("transformer.") for k in ema)
    args = ["--device-type", "cpu", "--model-arch", "bsrgantrans_x2", "--weights", path, "--use-ema"]

    out = tmp_path / "sr.png"
    infer.main(args + ["--inputs-path", str(valid / frame), "--output-path", str(out)])
    assert cv2.imread(str(out)).shape == (96, 96, 3)

    capsys.readouterr()
    request = {"id": 0, "input": str(valid / frame), "output": str(tmp_path / "served.png")}
    monkeypatch.setattr(sys, "stdin", io.StringIO(json.dumps(request) + '\n{"cmd": "shutdown"}'))
    serve.main(args + ["--stdio"])
    replies = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert [(r["ok"], r["out_hw"]) for r in replies] == [(True, [96, 96])]
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "served.png")), cv2.imread(str(out)))
