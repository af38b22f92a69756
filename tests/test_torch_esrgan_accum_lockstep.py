"""The G-first step's gradient accumulation in the port's ``Trainer``
against the JAX package's: ``esrgan`` (relativistic, against the BatchNorm
VGG-128 D) with ``grad_accum_steps=2``, f64 lockstep from one converted
state, parameters, Adams, EMA-G and running statistics in f64 in both
trainers, held as ``tests/test_torch_esrgan_lockstep.py`` holds the
unaccumulated step. The content loss is off, as there. Inputs are made with
numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from srganfd_tpu import configs as jax_configs
from srganfd_tpu.train.loop import Trainer as JaxTrainer
from srganfd_tpu_torch import configs
from srganfd_tpu_torch.convert import flax_to_state_dict, vgg_discriminator_flax_to_state_dict
from srganfd_tpu_torch.train.loop import Trainer
from test_torch_train_options import _held, _jax_state_in_f64, _port_state_in_f64, _t
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

ESRGAN = dict(compute_dtype="float64", epochs=4, g_kwargs={"channels": 16, "growth_channels": 8, "num_blocks": 1},
              d_kwargs={"channels": 8}, content_weight=(), grad_accum_steps=2)


def test_esrgan_grad_accum_lockstep_with_jax_trainer():
    """Two ``esrgan`` steps (G first, relativistic, the BatchNorm D), batch
    2 in two chunks of one frame: the G phase's per-chunk forwards and relativistic
    terms, the D phase's per-chunk opponent means, batch statistics and
    running statistics advanced chunk by chunk on the concatenated SR.
    Held as ``test_esrgan_recipe_lockstep_with_jax_trainer`` holds the
    unaccumulated step: losses to 1e-9, G, EMA-G, D and its running
    statistics to 1e-9 of each tensor's largest entry but the two biases
    whose gradient is roundoff."""
    n_steps, batch, gt_size = 2, 2, 128
    jtr = JaxTrainer(jax_configs.get_config("esrgan", **ESRGAN), steps_per_epoch=1)
    jst = _jax_state_in_f64(jtr, jax.jit(jtr.init_state, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), (batch, gt_size // 4, gt_size // 4, 3), (batch, gt_size, gt_size, 3)))
    cfg = configs.get_config("esrgan", **ESRGAN)
    rng = np.random.default_rng(7)
    gts = rng.uniform(size=(n_steps, batch, gt_size, gt_size, 3)).astype(np.float32)
    lrs = np.ascontiguousarray(gts[:, :, ::4, ::4, :])

    def d_state(params, d_vars):
        return vgg_discriminator_flax_to_state_dict(params, d_vars["batch_stats"])

    init = {k: _t(v) for k, v in flax_to_state_dict(jst.g_params).items()}
    d_init = {k: _t(v) for k, v in d_state(jst.d_params, jst.d_vars).items()}
    tr = Trainer(cfg, steps_per_epoch=1)
    st = _port_state_in_f64(tr.init_state(init, d_init), init, d_init)
    keys = ("pixel_loss", "adversarial_loss", "g_loss", "d_loss", "d_gt_probability", "d_sr_probability")
    jax_metrics, metrics = [], []
    for i in range(n_steps):
        jst, m = jtr.train_step(jst, jnp.asarray(gts[i]), jnp.asarray(lrs[i]))
        jax_metrics.append([float(m[k]) for k in keys])
        out = tr.train_step(st, _t(gts[i]), _t(lrs[i]))
        metrics.append([float(out[k]) for k in keys])
    np.testing.assert_allclose(metrics, jax_metrics, rtol=1e-9, atol=0)
    _held([("G", dict(st.g_model.named_parameters()), flax_to_state_dict(jst.g_params)),
           ("EMA-G", st.ema_g, flax_to_state_dict(jst.ema_g_params)),
           ("D", st.d_model.state_dict(), d_state(jst.d_params, jst.d_vars))], cfg.model_lr)
    stats = [k for k in d_init if k.endswith(("running_mean", "running_var"))]
    assert stats and all(not torch.equal(st.d_model.state_dict()[k], d_init[k]) for k in stats)
