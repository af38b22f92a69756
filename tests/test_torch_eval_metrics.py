"""The metrics of ``srganfd_tpu_torch.cli.test`` against the JAX package's
on the CPU: the masked PSNR/SSIM of bucket-padded batches, NIQE (the numpy
implementation and the bit-exact torch twin, both the port's own copies)
on the NIQE goldens and a random frame, and the tracker's image and dict
files. Inputs are made with numpy from seeds.
"""

import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu.metrics import niqe as jax_niqe
from srganfd_tpu.metrics import niqe_torch as jax_niqe_torch
from srganfd_tpu.metrics import psnr_ssim as jax_metrics
from srganfd_tpu_torch.metrics import niqe, niqe_torch, psnr_ssim
from srganfd_tpu_torch.track import tracker
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

ASSET = os.path.join(os.path.dirname(niqe.__file__), "..", "assets", "niqe_cfd_bubbles.npz")


def _padded_batch(dtype, seed):
    """Four 72 x 80 images whose valid regions differ, the rest
    reflect-padded as cli.test pads; SR a noisy copy of GT."""
    rng = np.random.default_rng(seed)
    valid = np.array([[72, 80], [40, 66], [64, 17], [23, 50]], np.int32)
    gt = rng.uniform(size=(4, 72, 80, 3))
    for i, (h, w) in enumerate(valid):
        gt[i] = np.pad(gt[i, :h, :w], ((0, 72 - h), (0, 80 - w), (0, 0)), mode="reflect")
    sr = np.clip(gt + 0.05 * rng.standard_normal(gt.shape), 0, 1)
    return sr.astype(dtype), gt.astype(dtype), valid


@pytest.mark.parametrize("y_only", [True, False], ids=["y", "rgb"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_padded_psnr_ssim_match_jax(dtype, y_only):
    """Per image, against the JAX ``psnr_tensor_padded``/``ssim_tensor_padded``
    (f64 accumulation in both, x64 on for JAX), with a border of 2: PSNR
    of RGB to 1e-9 dB; of Y to 1e-5 dB, since both frameworks convert to Y
    in f32 as the reference does and round the three-term product apart by
    an ulp (measured 1.4e-6 dB); SSIM to 1e-6 (returned in f32 by both);
    and each equal to the port's unpadded metric on the cropped image, to
    the same tolerances."""
    sr, gt, valid = _padded_batch(dtype, 3)
    want_p = np.asarray(jax_metrics.psnr_tensor_padded(jnp.asarray(sr), jnp.asarray(gt), jnp.asarray(valid), 2, y_only))
    want_s = np.asarray(jax_metrics.ssim_tensor_padded(jnp.asarray(sr), jnp.asarray(gt), jnp.asarray(valid), 2, y_only))
    t_sr, t_gt, t_valid = torch.from_numpy(sr), torch.from_numpy(gt), torch.from_numpy(valid)
    got_p = psnr_ssim.psnr_tensor_padded(t_sr, t_gt, t_valid, 2, y_only)
    got_s = psnr_ssim.ssim_tensor_padded(t_sr, t_gt, t_valid, 2, y_only)
    assert got_p.dtype == torch.float64 and got_s.dtype == torch.float32
    tol_p = 1e-5 if y_only else 1e-9
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=0, atol=tol_p)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=1e-6)
    for i, (h, w) in enumerate(valid):
        crop = lambda t: t[i:i + 1, :h, :w]  # noqa: E731
        # Y: torch's f32 product rounds by the tensor's shape (2.4e-7 dB measured)
        assert got_p[i].item() == pytest.approx(psnr_ssim.psnr_tensor(crop(t_sr), crop(t_gt), 2, y_only).item(),
                                                abs=tol_p)
        assert got_s[i].item() == pytest.approx(psnr_ssim.ssim_tensor(crop(t_sr), crop(t_gt), 2, y_only).item(),
                                                abs=1e-6)


@pytest.fixture(scope="module")
def frames(goldens):
    g = goldens("niqe_full")
    rng = np.random.default_rng(9)
    noise = np.clip(0.5 + 0.2 * rng.standard_normal((200, 300, 3)), 0, 1) * 255.0
    return {"test_img": g["test_img"], "blur_img": g["blur_img"], "crop_img": g["crop_img"], "random": noise}


@pytest.mark.parametrize("convention", ["torch", "numpy"])
def test_niqe_numpy_matches_jax_bit_for_bit(frames, goldens, convention):
    """The port's ``niqe`` (BGR [0, 255]) on the goldens' frames and a
    random one, with the goldens' model and the port's asset: equal to the
    JAX ``niqe`` bit for bit, in both Y conventions; the asset is the JAX
    package's file byte for byte."""
    g = goldens("niqe_full")
    models = [(niqe.NiqeModel(g["mu"], g["cov"]), jax_niqe.NiqeModel(g["mu"], g["cov"])),
              (niqe.load_niqe_model(ASSET), jax_niqe.load_niqe_model(ASSET))]
    for name, img in frames.items():
        crop = 4 if name == "crop_img" else 0
        for ours, theirs in models:
            got = niqe.niqe(img, ours, crop_border=crop, convention=convention)
            want = jax_niqe.niqe(img, theirs, crop_border=crop, convention=convention)
            assert np.isfinite(got) and got == want, (name, got, want)
    with open(ASSET, "rb") as f, open(os.path.join(os.path.dirname(jax_niqe.__file__), "..", "assets",
                                                   "niqe_cfd_bubbles.npz"), "rb") as g2:
        assert f.read() == g2.read()


def test_niqe_twin_matches_jax_bit_for_bit(frames, goldens):
    """The port's ``niqe_torch_exact`` (RGB [0, 1]) on the same frames, bit
    for bit against the JAX twin; and the golden's reference score of the
    torch module on its test frame, as the JAX package's test holds it."""
    g = goldens("niqe_full")
    model = niqe.load_niqe_model(ASSET)
    for name, img in frames.items():
        rgb = (img[..., ::-1] / 255.0).astype(np.float32)
        got = niqe_torch.niqe_torch_exact(rgb, model)
        assert got == jax_niqe_torch.niqe_torch_exact(rgb, jax_niqe.load_niqe_model(ASSET)), name
    rgb = (g["test_img"][..., ::-1] / 255.0).astype(np.float32)
    got = niqe_torch.niqe_torch_exact(rgb, niqe.NiqeModel(g["mu"], g["cov"]))
    assert got == jax_niqe_torch.niqe_torch_exact(rgb, jax_niqe.NiqeModel(g["mu"], g["cov"]))


def test_niqe_twin_skips_a_frame_without_blocks_by_value_error():
    """Below two 96 px blocks the twin raises the ValueError that cli.test
    catches (the JAX twin raises a RuntimeError from ``F.pad`` with no
    block at all)."""
    model = niqe.load_niqe_model(ASSET)
    with pytest.raises(ValueError, match="2 96px blocks"):
        niqe_torch.niqe_torch_exact(np.zeros((90, 300, 3), np.float32), model)
    with pytest.raises(RuntimeError):
        jax_niqe_torch.niqe_torch_exact(np.zeros((90, 300, 3), np.float32), jax_niqe.load_niqe_model(ASSET))


def test_tracker_writes_images_and_dicts(tmp_path, monkeypatch):
    """``log_image``: a float [0, 1] RGB image as an 8-bit PNG in BGR, a
    one-channel map as a grey PNG, uint8 as it is, each with its JSONL
    record; ``log_dict``: the JSON file, numpy scalars as numbers."""
    monkeypatch.setattr(tracker, "_optional_summary_writer", lambda: None)
    t = tracker.Tracker("exp", samples_dir=str(tmp_path))
    rng = np.random.default_rng(2)
    rgb = rng.uniform(size=(5, 7, 3)).astype(np.float32)
    t.log_image(rgb, "sr_0000")
    t.log_image(np.full((4, 6, 1), 0.5, np.float32), "d/gt")
    t.log_image(np.full((3, 3, 3), 7, np.uint8), "raw.png")
    t.log_dict({"PSNR": np.float64(30.5), "SSIM": 0.9}, "test_metrics")
    t.close()
    d = tmp_path / "logs" / "exp"
    png = cv2.imread(str(d / "sr_0000.png"))
    np.testing.assert_array_equal(png[..., ::-1], np.clip(rgb * 255.0, 0, 255).astype(np.uint8))
    grey = cv2.imread(str(d / "d_gt.png"), cv2.IMREAD_UNCHANGED)
    assert grey.shape == (4, 6) and (grey == 127).all()
    assert (cv2.imread(str(d / "raw.png")) == 7).all()
    assert json.loads((d / "test_metrics.json").read_text()) == {"PSNR": 30.5, "SSIM": 0.9}
    records = [json.loads(line) for line in (d / "events.jsonl").read_text().splitlines()]
    assert [r["name"] for r in records if r["type"] == "image"] == ["sr_0000", "d/gt", "raw.png"]
