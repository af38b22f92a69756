"""The port's training slice against the JAX package's: the data loader,
the degradation adapter, the metrics, the schedule, the EMA, every
config, and three lockstep ``bsrnet`` steps of the two trainers from one
converted init.

Inputs are made with numpy from a seed and handed to both frameworks.
Tiny widths (16 channels, growth 8, 1 RRDB); the JAX ``Trainer`` is
compiled once.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu import configs as jax_configs
from srganfd_tpu.cli.degrade_adapter import DegradationAdapter as JaxAdapter
from srganfd_tpu.data import datasets as jax_datasets
from srganfd_tpu.metrics import psnr_ssim as jax_metrics
from srganfd_tpu.train import schedule as jax_schedule
from srganfd_tpu.train import state as jax_state
from srganfd_tpu.train.loop import Trainer as JaxTrainer
from srganfd_tpu_torch import configs
from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
from srganfd_tpu_torch.convert import flax_to_state_dict
from srganfd_tpu_torch.data import datasets
from srganfd_tpu_torch.metrics import psnr_ssim
from srganfd_tpu_torch.models import check_ported
from srganfd_tpu_torch.train import schedule, state
from srganfd_tpu_torch.train.loop import Trainer
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TINY = {"channels": 16, "growth_channels": 8, "num_rrdb": 1}


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("gt")
    rng = np.random.default_rng(0)
    for i in range(6):
        h, w = 40 + 3 * i, 44 - 2 * i
        yy, xx = np.mgrid[0:h, 0:w] / 48
        base = 0.5 + 0.3 * np.sin(2 * np.pi * (xx * (i + 1) + yy))
        img = np.clip(base[..., None] + 0.1 * rng.standard_normal((h, w, 3)), 0, 1)
        cv2.imwrite(os.path.join(d, f"{i:02d}.png"), (img * 255).astype(np.uint8))
    # one image below the pre-crop size: reflect-padded up to it
    cv2.imwrite(os.path.join(d, "small.png"), (rng.uniform(size=(20, 30, 3)) * 255).astype(np.uint8))
    return str(d)


# -- data -------------------------------------------------------------------------


@pytest.mark.parametrize("mode,start_batch", [("Train", 0), ("Train", 5), ("Valid", 0)])
def test_batch_loader_matches_jax(image_dir, mode, start_batch):
    ours = datasets.BatchLoader(
        datasets.TrainValidImageDataset(image_dir, 32, mode, 32), 2, shuffle=mode == "Train",
        seed=3, num_workers=2, start_batch=start_batch, loop=mode == "Train",
    )
    theirs = jax_datasets.BatchLoader(
        jax_datasets.TrainValidImageDataset(image_dir, 32, mode, 32), 2, shuffle=mode == "Train",
        seed=3, num_workers=2, start_batch=start_batch, loop=mode == "Train",
    )
    got, want = [], []
    for loader, out in ((ours, got), (theirs, want)):
        for i, batch in enumerate(loader):
            out.append(batch["gt"])
            if i == 4:
                break
    assert len(got) == len(want) == (5 if mode == "Train" else 3)
    for g, w in zip(got, want):
        assert g.shape == (2, 32, 32, 3) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_adapter_train_plans_and_crops_match_jax():
    cfg = configs.get_config("bsrnet", gt_image_size=24)
    jcfg = jax_configs.get_config("bsrnet", gt_image_size=24)
    host = {"gt": np.random.default_rng(1).uniform(size=(3, 48, 48, 3)).astype(np.float32)}
    ours, theirs = DegradationAdapter(cfg, seed=4, train=True), JaxAdapter(jcfg, seed=4, train=True)
    for step in (0, 7):
        a, b = ours.step_rng(step), theirs.step_rng(step)
        assert a.random() == b.random()  # keyed alike: (seed, tag, host, step)
        got, want = ours(host, step), theirs(host, step)
        assert got["gt"].shape == (3, 24, 24, 3) and got["lr"].shape == (3, 12, 12, 3)
        # the same plan and the same crop offsets: the GT crops are equal
        np.testing.assert_array_equal(got["gt"].numpy(), np.asarray(want["gt"]))
        diff = np.abs(got["lr"].numpy() - np.asarray(want["lr"]))
        assert diff.max() < 0.02 and diff.mean() <= 1e-4, (diff.max(), diff.mean())


def test_adapter_eval_keeps_full_gt():
    cfg = configs.get_config("bsrnet")
    host = {"gt": np.random.default_rng(2).uniform(size=(2, 32, 32, 3)).astype(np.float32)}
    out = DegradationAdapter(cfg, seed=0, train=False)(host, 0)
    assert out["gt"].shape == (2, 32, 32, 3) and out["lr"].shape == (2, 16, 16, 3)


@pytest.mark.parametrize("degradation", ["paired"])
def test_adapter_names_the_roadmap_item_for_other_degradations(degradation):
    """The last degradation the port lacked, ``paired``, is ported: GT and
    LR reach the device as the loader read them; an unknown name raises."""
    cfg = configs.get_config("bsrnet").replace(degradation=degradation)
    rng = np.random.default_rng(6)
    host = {"gt": rng.uniform(size=(2, 16, 16, 3)).astype(np.float32),
            "lr": rng.uniform(size=(2, 8, 8, 3)).astype(np.float32)}
    out = DegradationAdapter(cfg)(host, 0)
    assert all(np.array_equal(out[k].numpy(), host[k]) for k in ("gt", "lr"))
    with pytest.raises(ValueError, match="unknown degradation"):
        DegradationAdapter(cfg.replace(degradation="jpeg_only"))


# -- metrics ------------------------------------------------------------------------


@pytest.mark.parametrize("crop_border,y_only", [(0, True), (2, True), (2, False)])
def test_psnr_ssim_match_jax(crop_border, y_only):
    rng = np.random.default_rng(5)
    raw = rng.uniform(size=(3, 30, 26, 3)).astype(np.float32)
    dst = np.clip(raw + 0.05 * rng.standard_normal(raw.shape), 0, 1).astype(np.float32)
    t, j = torch.from_numpy, jnp.asarray
    got_p = psnr_ssim.psnr_tensor(t(raw), t(dst), crop_border, y_only)
    got_s = psnr_ssim.ssim_tensor(t(raw), t(dst), crop_border, y_only)
    assert got_p.dtype == torch.float64 and got_s.dtype == torch.float32
    want_p = jax_metrics.psnr_tensor(j(raw), j(dst), crop_border, y_only)
    want_s = jax_metrics.ssim_tensor(j(raw), j(dst), crop_border, y_only)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)


def test_numpy_convention_psnr_ssim_match_jax():
    rng = np.random.default_rng(6)
    raw = rng.integers(0, 256, size=(28, 24, 3)).astype(np.uint8)
    dst = np.clip(raw.astype(np.int32) + rng.integers(-9, 10, raw.shape), 0, 255).astype(np.uint8)
    for crop_border, y_only in ((0, True), (3, False)):
        np.testing.assert_allclose(psnr_ssim.psnr(raw, dst, crop_border, y_only),
                                   jax_metrics.psnr(raw, dst, crop_border, y_only), rtol=1e-6)
        np.testing.assert_allclose(psnr_ssim.ssim(raw, dst, crop_border, y_only),
                                   jax_metrics.ssim(raw, dst, crop_border, y_only), rtol=1e-6)


# -- schedule and EMA -------------------------------------------------------------------


def test_multistep_lr_matches_jax_over_40_steps():
    cfg = configs.get_config("bsrnet", epochs=8)
    spe = 5
    milestones = tuple(m * spe for m in cfg.milestones_epochs)  # int(8*0.5)*5, int(8*0.7)*5
    ours = schedule.multistep_lr(cfg.model_lr, milestones, cfg.lr_scheduler_gamma)
    theirs = jax_schedule.multistep_lr(cfg.model_lr, milestones, cfg.lr_scheduler_gamma)
    got = [ours(c) for c in range(40)]
    np.testing.assert_allclose(got, [float(theirs(c)) for c in range(40)], rtol=1e-7)
    assert got[19] == cfg.model_lr and got[20] == cfg.model_lr * 0.5 and got[30] == cfg.model_lr * 0.25


@pytest.mark.parametrize("reference_semantics,step", [(False, 3), (True, 0), (True, 3)],
                         ids=["conventional", "reference_first", "reference"])
def test_ema_update_matches_jax(reference_semantics, step):
    rng = np.random.default_rng(7)
    ema = {k: rng.normal(size=(5, 3)).astype(np.float32) for k in "ab"}
    new = {k: rng.normal(size=(5, 3)).astype(np.float32) for k in "ab"}
    got = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    state.ema_update(got, {k: torch.from_numpy(v) for k, v in new.items()}, 0.999,
                     reference_semantics=reference_semantics, step=step)
    want = jax_state.ema_update(ema, new, 0.999, reference_semantics=reference_semantics,
                                step=jnp.asarray(step))
    for k in ema:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


# -- the trainer in lockstep ----------------------------------------------------------------


def test_bsrnet_lockstep_with_jax_trainer():
    """Three f32 steps of each trainer from one Flax init, on the same
    (gt, lr) arrays. One step per epoch over 4 epochs puts both milestones
    at step 2, so the third update also checks the schedule's count. The
    bounds are those of ``tests/test_train_parity.py``."""
    n_steps, batch, gt_size = 3, 2, 24
    jcfg = jax_configs.get_config("bsrnet", compute_dtype="float32", epochs=4, g_kwargs=TINY)
    cfg = configs.get_config("bsrnet", compute_dtype="float32", epochs=4, g_kwargs=TINY)
    rng = np.random.default_rng(42)
    gts = rng.uniform(size=(n_steps, batch, gt_size, gt_size, 3)).astype(np.float32)
    lrs = np.ascontiguousarray(gts[:, :, ::2, ::2, :])

    jtr = JaxTrainer(jcfg, steps_per_epoch=1)
    jst = jtr.init_state(jax.random.PRNGKey(0), lrs.shape[1:], gts.shape[1:])
    init = {k: torch.from_numpy(np.array(v)) for k, v in flax_to_state_dict(jst.g_params).items()}

    tr = Trainer(cfg, steps_per_epoch=1)
    st = tr.init_state(init)
    jax_losses, losses, lrs_used = [], [], []
    for i in range(n_steps):
        jst, metrics = jtr.train_step(jst, jnp.asarray(gts[i]), jnp.asarray(lrs[i]))
        jax_losses.append(float(metrics["pixel_loss"]))
        out = tr.train_step(st, torch.from_numpy(gts[i]), torch.from_numpy(lrs[i]))
        losses.append(float(out["pixel_loss"]))
        lrs_used.append(st.g_opt.param_groups[0]["lr"])
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-6, atol=2e-7)
    assert lrs_used == [1e-4, 1e-4, 2.5e-5]
    assert st.step == n_steps

    for name, ours_tree, theirs_tree in (
        ("G", dict(st.g_model.named_parameters()), jst.g_params),
        ("EMA-G", st.ema_g, jst.ema_g_params),
    ):
        want = flax_to_state_dict(theirs_tree)
        assert set(ours_tree) == set(want)
        for k in sorted(want):
            np.testing.assert_allclose(ours_tree[k].detach().numpy(), np.asarray(want[k]),
                                       rtol=5e-4, atol=2e-6, err_msg=f"{name} {k}")
    moved = max(float((st.g_model.state_dict()[k] - init[k]).abs().max()) for k in init)
    assert moved > 1e-4, f"suspiciously small update {moved}"


def test_trainer_names_the_roadmap_item_for_unported_options():
    """The one option of the JAX ``Trainer`` the port refuses, naming A11:
    the multi-slice ``dcn_mesh_shape``. The pipe mesh's microbatches and
    meshes with a ``model`` or ``pipe`` axis build (a world of one here;
    a ``pipe`` axis needs ``scan_blocks``, as in JAX); the default mesh,
    the ``data`` axis over every rank, builds; a ``data`` shape other than
    the world raises as JAX's ``make_mesh`` does."""
    cfg = configs.get_config("bsrnet", g_kwargs=TINY)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
        Trainer(cfg.replace(dcn_mesh_shape=(1,)))
    for over in ({"pipeline_microbatches": 2}, {"mesh_shape": (1, -1), "mesh_axes": ("data", "model")},
                 {"mesh_shape": (-1, 1), "mesh_axes": ("data", "pipe"), "g_kwargs": {**TINY, "scan_blocks": True}}):
        assert Trainer(cfg.replace(**over)).mesh.world == 1
    Trainer(cfg.replace(mesh_shape=(1,)))
    with pytest.raises(ValueError, match=r"mesh shape \(2,\) != 1 ranks"):
        Trainer(cfg.replace(mesh_shape=(2,)))


def test_a_discriminator_without_an_adversarial_weight_is_refused():
    """No step would train it, so a ``d_arch`` on a config without an
    adversarial weight is an error, not an untrained D in the checkpoints."""
    cfg = configs.get_config("bsrnet", g_kwargs=TINY, d_arch="discriminator_unet")
    assert not cfg.is_gan
    with pytest.raises(ValueError, match="adversarial_weight"):
        Trainer(cfg)


@pytest.mark.parametrize("name", ["rrdbnet", "esrgan", "bsrnet", "bsrgan", "realesrnet", "realesrgan", "aesrgan"])
def test_config_equals_the_jax_one(name):
    """Every config of the JAX package, field by field (the degradation
    dicts and the milestones included); its G and D archs are the port's."""
    import dataclasses

    ours, theirs = configs.get_config(name), jax_configs.get_config(name)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.milestones_epochs == theirs.milestones_epochs
    assert ours.is_gan == (name in ("esrgan", "bsrgan", "realesrgan", "aesrgan"))
    for arch in (ours.g_arch, ours.d_arch):
        if arch is not None:
            check_ported(arch)
