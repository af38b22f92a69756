"""Three lockstep ``bsrgan`` steps of the port's ``Trainer`` against the
JAX package's ``Trainer`` from one converted G, D and ``u``, the content
loss on the JAX surrogate VGG19, for ``fuse_d_forwards`` False and True.

Inputs are made with numpy from a seed and handed to both trainers. Tiny
widths: G 16 channels, growth 8, 2 RRDBs; D 8 channels; GT 32 x 32 (the
VGG19's deepest node, ``features.34``, at 2 x 2). The JAX trainer is
built once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


@pytest.fixture(scope="module")
def jax_gan():
    """The JAX ``Trainer`` of the tiny f64 ``bsrgan`` config, and its initial
    state (G, D, ``u``); its content loss holds the JAX surrogate VGG19
    (``PRNGKey(42)``)."""
    cfg = jax_configs.get_config("bsrgan", compute_dtype="float64", epochs=4, g_kwargs=TINY_G,
                                 d_kwargs=TINY_D)
    trainer = JaxTrainer(cfg, steps_per_epoch=1)
    init = jax.jit(trainer.init_state, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), (2, 16, 16, 3), (2, 32, 32, 3))
    return trainer, init


@pytest.mark.parametrize("fuse", [False, True], ids=["two_d_forwards", "fused_d_forwards"])
def test_bsrgan_lockstep_with_jax_trainer(jax_gan, fuse):
    """Three ``bsrgan`` steps of each trainer from one Flax init (G, D and
    its ``u``; the content loss on the JAX surrogate VGG19), on the same
    (gt, lr) arrays. One step per epoch over 4 epochs puts both milestones
    at step 2, so the third update checks both schedules' count. The
    bounds are ``test_bsrnet_lockstep_with_jax_trainer``'s: losses rtol
    2e-6, atol 2e-7; parameters rtol 5e-4, atol 2e-6; the ``u`` vectors
    too. The content loss alone is held at rtol 1e-5: it is the one loss
    both trainers compute in f32 (VGG19 emits f32 features under f64
    compute, as the JAX module does), and it read 5.8e-7 relative at step
    0, from the same parameters, and 1.5e-6 - 1.6e-6 at step 1 (0.79 of
    2e-6), at 1, 2 and 6 torch threads alike.

    The step computes in f64 (parameters and Adam stay f32), as the JAX
    package's own lockstep tests do: in f32 the two frameworks' roundoff in
    the content loss's gradient (sums of O(10) terms, ~1e-5 apart) reaches
    weights whose gradient is below Adam's eps = 1e-4, whose update is then
    proportional to it, and moves them up to 3e-5 apart in one step. The
    JAX trainer is the module's, its config's ``fuse_d_forwards`` set for
    this case before its step is traced."""
    n_steps = 3
    jtr, jst = jax_gan
    jtr.cfg = jtr.cfg.replace(fuse_d_forwards=fuse)
    jax_step = jtr.make_train_step()
    cfg = configs.get_config("bsrgan", compute_dtype="float64", epochs=4, g_kwargs=TINY_G, d_kwargs=TINY_D,
                             fuse_d_forwards=fuse)
    rng = np.random.default_rng(42)
    gts = rng.uniform(size=(n_steps, 2, 32, 32, 3)).astype(np.float32)
    lrs = np.ascontiguousarray(gts[:, :, ::2, ::2, :])

    init = {k: _t(v) for k, v in flax_to_state_dict(jst.g_params).items()}
    d_init = {k: _t(v) for k, v in discriminator_flax_to_state_dict(jst.d_params, jst.d_vars["spectral"]).items()}
    vgg = {k: _t(v) for k, v in vgg19_flax_to_state_dict(jtr.content_loss.variables["params"]).items()}
    tr = Trainer(cfg, steps_per_epoch=1)
    tr.content_loss.module.load_state_dict(vgg)
    st = tr.init_state(init, d_init)
    keys = ("d_loss", "d_gt_probability", "d_sr_probability", "pixel_loss", "content_loss",
            "adversarial_loss", "g_loss")
    jax_metrics, metrics, lrs_used = [], [], []
    for i in range(n_steps):
        # the jitted step donates its state: step a copy, keep the fixture's
        jst, m = jax_step(jst if i else jax.tree_util.tree_map(jnp.copy, jst),
                          jnp.asarray(gts[i]), jnp.asarray(lrs[i]))
        jax_metrics.append([float(m[k]) for k in keys])
        out = tr.train_step(st, _t(gts[i]), _t(lrs[i]))
        assert tuple(out) == keys
        metrics.append([float(out[k]) for k in keys])
        lrs_used.append((st.g_opt.param_groups[0]["lr"], st.d_opt.param_groups[0]["lr"]))
    content = keys.index("content_loss")
    others = [i for i in range(len(keys)) if i != content]
    np.testing.assert_allclose(np.array(metrics)[:, others], np.array(jax_metrics)[:, others], rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(np.array(metrics)[:, content], np.array(jax_metrics)[:, content], rtol=1e-5, atol=2e-7)
    assert lrs_used == [(8e-5, 2e-4), (8e-5, 2e-4), (8e-5 * 0.85**2, 2e-4 * 0.85**2)]
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
    assert not torch.equal(st.d_model.conv1.u, d_init["conv1.u"])
