"""Three lockstep ``aesrgan`` steps of the port's ``Trainer`` against the
JAX package's ``Trainer`` from one converted G, D, ``u`` and BatchNorm
state: the D-first step against the attention-gated U-Net discriminator,
whose gates normalise with their batches' statistics and write running
ones.

Inputs are made with numpy from a seed and handed to both trainers. The
content loss is off and G is overridden to a tiny ``bsrgan_x2`` (8
channels, growth 4, 1 RRDB), as ``tests/test_train_parity.py``'s A-ESRGAN
lockstep does and for its reason: the step's rule is what is pinned here
(``bsrgantrans_x2``'s gradients are ``test_torch_aesrgan_model.py``'s).
D at 8 features, GT 32 x 32. One JAX trainer, one step compiled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from srganfd_tpu import configs as jax_configs
from srganfd_tpu.train.loop import Trainer as JaxTrainer
from srganfd_tpu_torch import configs
from srganfd_tpu_torch.convert import attention_discriminator_flax_to_state_dict, flax_to_state_dict
from srganfd_tpu_torch.train.loop import Trainer
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

OVER = dict(compute_dtype="float64", epochs=4, content_weight=(), g_arch="bsrgan_x2",
            g_kwargs={"channels": 8, "growth_channels": 4, "num_rrdb": 1}, d_kwargs={"num_feat": 8})


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _d_state(params, d_vars):
    return attention_discriminator_flax_to_state_dict(params, d_vars["batch_stats"], d_vars["spectral"])


def _inputs(n_steps, seed=42):
    rng = np.random.default_rng(seed)
    gts = rng.uniform(size=(n_steps, 2, 32, 32, 3)).astype(np.float32)
    return gts, np.ascontiguousarray(gts[:, :, ::2, ::2, :])


def test_aesrgan_lockstep_with_jax_trainer():
    """Three steps of each trainer from one Flax init on the same (gt, lr)
    arrays, in f64 compute (parameters and Adam f32), as
    ``test_torch_gan_lockstep.py`` runs ``bsrgan`` and for its reason. One
    step per epoch over 4 epochs puts the milestones (0.15, 0.3, 0.6) at
    steps 0, 1 and 2, so every update checks both schedules' count. Bounds
    as there: losses rtol 2e-6, atol 2e-7; parameters (G, EMA-G, D with
    every ``u`` and the gates' running mean and variance) rtol 5e-4, atol
    2e-6."""
    n_steps = 3
    jtr = JaxTrainer(jax_configs.get_config("aesrgan", **OVER), steps_per_epoch=1)
    jst = jax.jit(jtr.init_state, static_argnums=(1, 2))(jax.random.PRNGKey(0), (2, 16, 16, 3), (2, 32, 32, 3))
    jax_step = jtr.make_train_step()
    cfg = configs.get_config("aesrgan", **OVER)
    assert not cfg.g_step_first and set(jst.d_vars) == {"batch_stats", "spectral"}
    gts, lrs = _inputs(n_steps)

    init = {k: _t(v) for k, v in flax_to_state_dict(jst.g_params).items()}
    d_init = {k: _t(v) for k, v in _d_state(jst.d_params, jst.d_vars).items()}
    # the step gives the gates' running statistics back in the f64 compute
    # dtype; starting from them in f64 (exactly the f32 values, which the
    # update promotes anyway) lets the second step reuse the first's compile
    jst = jst.replace(d_vars={**jst.d_vars, "batch_stats": jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64), jst.d_vars["batch_stats"])})
    tr = Trainer(cfg, steps_per_epoch=1)
    st = tr.init_state(init, d_init)
    keys = ("d_loss", "d_gt_probability", "d_sr_probability", "pixel_loss", "adversarial_loss", "g_loss")
    jax_metrics, metrics, lrs_used = [], [], []
    for i in range(n_steps):
        jst, m = jax_step(jst, jnp.asarray(gts[i]), jnp.asarray(lrs[i]))
        jax_metrics.append([float(m[k]) for k in keys])
        out = tr.train_step(st, _t(gts[i]), _t(lrs[i]))
        assert set(out) == set(keys)
        metrics.append([float(out[k]) for k in keys])
        lrs_used.append((st.g_opt.param_groups[0]["lr"], st.d_opt.param_groups[0]["lr"]))
    np.testing.assert_allclose(metrics, jax_metrics, rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(lrs_used, [(5e-5 * 0.5**k, 1e-5 * 0.5**k) for k in (1, 2, 3)], rtol=1e-12)
    assert st.step == n_steps

    want_d = _d_state(jst.d_params, jst.d_vars)
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
    # two D forwards a step wrote the gates' statistics; the G term's wrote none
    stats = [k for k in d_init if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 6 and all(not torch.equal(st.d_model.state_dict()[k], d_init[k]) for k in stats)


def test_a_batchnorm_discriminator_keeps_two_d_forwards():
    """``fuse_d_forwards`` is not taken for a D with BatchNorm (one forward
    on [gt, sr] would pool the two batches' statistics), as in the JAX
    step: with it set, the step does what it does without it, bit for
    bit."""
    gts, lrs = _inputs(1, seed=3)
    runs = []
    for fuse in (False, True):
        cfg = configs.get_config("aesrgan", **{**OVER, "compute_dtype": "float32"}, fuse_d_forwards=fuse)
        tr = Trainer(cfg, steps_per_epoch=1)
        st = tr.init_state()
        calls = []
        st.d_model.register_forward_hook(lambda m, i, o: calls.append(i[0].shape[0]))
        metrics = tr.train_step(st, _t(gts[0]), _t(lrs[0]))
        runs.append((calls, {k: v.clone() for k, v in st.d_model.state_dict().items()}, metrics))
    assert runs[0][0] == runs[1][0] == [2, 2, 2]  # gt, sr, and the G term's sr
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
    assert all(torch.equal(runs[0][2][k], runs[1][2][k]) for k in runs[0][2])
