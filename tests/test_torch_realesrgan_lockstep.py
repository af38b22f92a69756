"""Three lockstep ``realesrgan`` steps of the port's ``Trainer`` against the
JAX package's ``Trainer`` from one converted G, D and ``u``: the G-first
GAN step, the pixel and content terms against a separate target
(``gt_pixel``, the USM-sharpened GT in training) while D judges ``gt``,
and the content loss (weights 0.1, 0.1, 1, 1, 1 over five VGG19 nodes) on
the JAX surrogate VGG19.

Inputs are made with numpy from a seed and handed to both trainers. Tiny
widths: G ``realesrgan_x4`` at 16 channels, growth 8, 2 RRDBs; D 8
channels; GT 32 x 32 (LR 8 x 8; no chain runs here, so the chain's
size limit does not apply). One JAX trainer, one step compiled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from srganfd_tpu import configs as jax_configs
from srganfd_tpu.train.loop import Trainer as JaxTrainer
from srganfd_tpu_torch import configs
from srganfd_tpu_torch.convert import (
    discriminator_flax_to_state_dict,
    flax_to_state_dict,
    vgg19_flax_to_state_dict,
)
from srganfd_tpu_torch.train.loop import Trainer
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TINY_G = {"channels": 16, "growth_channels": 8, "num_rrdb": 2}
TINY_D = {"channels": 8}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def test_realesrgan_lockstep_with_jax_trainer():
    """Three steps of each trainer from one Flax init on the same (gt, lr,
    gt_pixel) arrays, in f64 compute (parameters and Adam f32), as
    ``test_torch_gan_lockstep.py`` runs ``bsrgan`` and for its reason.
    One step per epoch over 8 epochs puts the milestones (0.125, 0.25) at
    steps 1 and 2, so each update checks both schedules' count.
    Bounds as there: losses rtol 2e-6, atol 2e-7; parameters (G, EMA-G,
    D with ``u``) rtol 5e-4, atol 2e-6."""
    n_steps = 3
    over = dict(compute_dtype="float64", epochs=8, g_kwargs=TINY_G, d_kwargs=TINY_D)
    jtr = JaxTrainer(jax_configs.get_config("realesrgan", **over), steps_per_epoch=1)
    jst = jax.jit(jtr.init_state, static_argnums=(1, 2))(jax.random.PRNGKey(0), (2, 8, 8, 3), (2, 32, 32, 3))
    jax_step = jtr.make_train_step(separate_pixel_target=True)
    cfg = configs.get_config("realesrgan", **over)
    assert cfg.g_step_first and jtr.cfg.g_step_first

    rng = np.random.default_rng(7)
    gts = rng.uniform(size=(n_steps, 2, 32, 32, 3)).astype(np.float32)
    # a target the pixel and content terms see and D does not
    pixels = np.clip(gts + 0.1 * rng.standard_normal(gts.shape), 0, 1).astype(np.float32)
    lrs = np.ascontiguousarray(gts[:, :, ::4, ::4, :])

    init = {k: _t(v) for k, v in flax_to_state_dict(jst.g_params).items()}
    d_init = {k: _t(v) for k, v in discriminator_flax_to_state_dict(jst.d_params, jst.d_vars["spectral"]).items()}
    vgg = {k: _t(v) for k, v in vgg19_flax_to_state_dict(jtr.content_loss.variables["params"]).items()}
    tr = Trainer(cfg, steps_per_epoch=1)
    tr.content_loss.module.load_state_dict(vgg)
    st = tr.init_state(init, d_init)
    keys = ("pixel_loss", "content_loss", "adversarial_loss", "g_loss", "d_loss", "d_gt_probability",
            "d_sr_probability")
    jax_metrics, metrics, lrs_used = [], [], []
    for i in range(n_steps):
        jst, m = jax_step(jst, jnp.asarray(gts[i]), jnp.asarray(lrs[i]), jnp.asarray(pixels[i]))
        jax_metrics.append([float(m[k]) for k in keys])
        out = tr.train_step(st, _t(gts[i]), _t(lrs[i]), _t(pixels[i]))
        assert set(out) == set(keys)
        metrics.append([float(out[k]) for k in keys])
        lrs_used.append((st.g_opt.param_groups[0]["lr"], st.d_opt.param_groups[0]["lr"]))
    np.testing.assert_allclose(metrics, jax_metrics, rtol=2e-6, atol=2e-7)
    assert lrs_used == [(1e-4, 1e-4), (5e-5, 5e-5), (2.5e-5, 2.5e-5)]
    assert st.step == n_steps

    want_d = discriminator_flax_to_state_dict(jst.d_params, jst.d_vars["spectral"])
    for name, ours, theirs in (
        ("G", dict(st.g_model.named_parameters()), flax_to_state_dict(jst.g_params)),
        ("EMA-G", st.ema_g, flax_to_state_dict(jst.ema_g_params)),
        ("D", st.d_model.state_dict(), want_d),
    ):
        assert set(ours) == set(theirs)
        for k in sorted(theirs):
            np.testing.assert_allclose(ours[k].detach().numpy(), theirs[k], rtol=5e-4, atol=2e-6,
                                       err_msg=f"{name} {k}")
    moved = max(float((st.d_model.state_dict()[k] - d_init[k]).abs().max()) for k in d_init)
    assert moved > 1e-4, f"suspiciously small D update {moved}"
