"""Three lockstep steps of the port's ``Trainer`` against the JAX package's
``Trainer`` for both stages of the ESRGAN recipe, from one converted state:
``rrdbnet`` (``rrdbnet_x4`` on L1) and ``esrgan`` (the G step first,
relativistic, against the VGG-128 discriminator, whose BatchNorms
normalise with their batches' statistics and write running ones from the
D update's two forwards only).

Inputs are made with numpy from a seed and handed to both trainers. The
content loss is off in ``esrgan``, as ``tests/test_train_parity.py``'s
ESRGAN lockstep runs it: ``test_torch_gan_lockstep.py`` holds the content
term's step already, and VGG19 in f64 at 128 x 128 would cost minutes.
Tiny widths: G 16 channels, growth 8, 2 RRDBs; D 8 channels. ``rrdbnet``
at GT 32, ``esrgan`` at GT 128 (the D's classifier reads a 4 x 4 map).
One JAX trainer per stage, one step compiled each.

Both trainers hold their parameters, Adam states, EMA-G and running
statistics in f64 here, not only compute in it (the packages keep
parameters in f32): each f32 update rounds a parameter to ~6e-8 of
itself, which the frameworks' Adams, running their f32 operations in
other orders, do differently, and the relativistic step against a
BatchNorm D carries such a difference on 10^4-fold in three steps (1e-7
relative to 1e-3, the port against itself with its parameters nudged by
1e-7 after the first step). In f64 the two trainers agree to 1e-9 after
three steps, which is what these tests hold, but for two tensors of D
whose gradient is, wholly or in part, the roundoff of a sum that is 0:

- ``relativistic_d_loss`` does not change when every logit moves by one
  constant, so the gradients of all rows' logits sum to exactly 0, and
  the logit's bias ``classifier.2.bias`` gets roundoff (0 - 1.1e-16 here)
  for a gradient. Adam turns that into ~lr * |g| / eps and leaves the bias
  at ~1e-14 - 1e-13, whose digits are the frameworks' roundoff: read
  relative to its largest entry it was 6.5 at one torch thread, 1.0 at six.
  It is held instead by its value, at roundoff far below one Adam step,
  and by its gradient at each step, roundoff against the other D
  gradients at the scale ``tests/test_torch_esrgan_model.py::
  test_relativistic_d_loss_gives_the_logit_bias_no_gradient`` uses in f64.
- A hidden unit of ``classifier.0`` whose LeakyReLU takes one slope on
  all four rows (GT and SR, 2 each) passes that zero sum on to its bias:
  24-30 of the 100 units at each step here, their gradients 0 - 2.1e-17
  in both frameworks. Adam moves each such bias by ~lr * 1e-9, so
  ``classifier.0.bias`` reads 1.6e-9 of its largest entry (8.7e-5) at 1, 4
  and 6 torch threads and 7.9e-10 at 2; its other 70-76 units agree to
  2.6e-14. It is held to 1e-8 (6x its worst reading).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu import configs as jax_configs
from srganfd_tpu.train.loop import Trainer as JaxTrainer
from srganfd_tpu_torch import configs
from srganfd_tpu_torch.convert import flax_to_state_dict, vgg_discriminator_flax_to_state_dict
from srganfd_tpu_torch.train.loop import Trainer
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TINY_G = {"channels": 16, "growth_channels": 8, "num_blocks": 2}
OVER = {
    "rrdbnet": dict(compute_dtype="float64", epochs=4, g_kwargs=TINY_G),
    "esrgan": dict(compute_dtype="float64", epochs=4, g_kwargs=TINY_G, d_kwargs={"channels": 8},
                   content_weight=()),
}
GT = {"rrdbnet": 32, "esrgan": 128}
# D tensors with a gradient of roundoff (module docstring): the logit's bias,
# held by value and gradient, and classifier.0's bias, held to 1e-8
LOGIT_BIAS = "classifier.2.bias"
ROUNDOFF_BOUND = {"classifier.0.bias": 1e-8}
KEYS = {
    "rrdbnet": ("pixel_loss", "g_loss"),
    "esrgan": ("pixel_loss", "adversarial_loss", "g_loss", "d_loss", "d_gt_probability", "d_sr_probability"),
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _d_state(params, d_vars) -> dict:
    return vgg_discriminator_flax_to_state_dict(params, d_vars["batch_stats"])


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _jax_state_in_f64(jtr, jst):
    """The JAX state with G, EMA-G, D and its running statistics in f64 and
    fresh Adam states over them."""
    g = _f64(jst.g_params)
    jst = jst.replace(g_params=g, g_opt_state=jtr.g_tx.init(g), ema_g_params=_f64(jst.ema_g_params))
    if jst.d_params is not None:
        d = _f64(jst.d_params)
        jst = jst.replace(d_params=d, d_opt_state=jtr.d_tx.init(d), d_vars=_f64(jst.d_vars))
    return jst


def _port_state_in_f64(st):
    """The port's fresh state with G, EMA-G, D and its buffers in f64: the
    modules convert their tensors in place, so the Adams, whose states are
    made at the first step, hold the same parameters."""
    st.g_model.double()
    st.ema_g = {k: v.double() for k, v in st.ema_g.items()}
    if st.d_model is not None:
        st.d_model.double()
    return st


@pytest.mark.parametrize("name", ["rrdbnet", "esrgan"])
def test_esrgan_recipe_lockstep_with_jax_trainer(name):
    """Three steps of each trainer from one Flax init on the same (gt, lr)
    arrays, all in f64 (see the module's docstring). One step per epoch
    over 4 epochs puts the milestones (0.125, 0.25, 0.5, 0.75) at steps 0,
    1, 2 and 3, so every update checks the schedules' count. Held: the
    losses and D's probabilities to 1e-9 relative; the learning rates
    exactly; G, EMA-G, D (weights, BatchNorm scales and biases, Linears)
    and D's running mean and variance to 1e-9 of each tensor's largest
    entry, but ``classifier.0.bias`` (1e-8) and the logit's bias: its
    value in both trainers below 1e-7 lr, its gradient in the port's at
    each step below 1e-15 while the logit weight's is above 1e-3."""
    n_steps, gt_size = 3, GT[name]
    jtr = JaxTrainer(jax_configs.get_config(name, **OVER[name]), steps_per_epoch=1)
    jst = _jax_state_in_f64(jtr, jax.jit(jtr.init_state, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), (2, gt_size // 4, gt_size // 4, 3), (2, gt_size, gt_size, 3)))
    cfg = configs.get_config(name, **OVER[name])
    gan = name == "esrgan"
    assert cfg.g_step_first and cfg.relativistic_gan == gan
    rng = np.random.default_rng(7)
    gts = rng.uniform(size=(n_steps, 2, gt_size, gt_size, 3)).astype(np.float32)
    lrs = np.ascontiguousarray(gts[:, :, ::4, ::4, :])

    init = {k: _t(v) for k, v in flax_to_state_dict(jst.g_params).items()}
    d_init = {k: _t(v) for k, v in _d_state(jst.d_params, jst.d_vars).items()} if gan else None
    tr = Trainer(cfg, steps_per_epoch=1)
    st = _port_state_in_f64(tr.init_state(init, d_init))
    jax_step = jtr.train_step
    jax_metrics, metrics, lrs_used, logit_grads = [], [], [], []
    for i in range(n_steps):
        jst, m = jax_step(jst, jnp.asarray(gts[i]), jnp.asarray(lrs[i]))
        jax_metrics.append([float(m[k]) for k in KEYS[name]])
        out = tr.train_step(st, _t(gts[i]), _t(lrs[i]))
        assert set(out) == set(KEYS[name])
        metrics.append([float(out[k]) for k in KEYS[name]])
        lrs_used.append([o.param_groups[0]["lr"] for o in (st.g_opt, st.d_opt) if o is not None])
        if gan:
            fc = st.d_model.classifier[2]
            logit_grads.append((fc.bias.grad.abs().max().item(), fc.weight.grad.abs().max().item()))
    np.testing.assert_allclose(metrics, jax_metrics, rtol=1e-9, atol=0)
    want_lr = [[cfg.model_lr * 0.5 ** k] * (2 if gan else 1) for k in (1, 2, 3)]
    assert lrs_used == want_lr
    assert st.step == n_steps

    trees = [("G", dict(st.g_model.named_parameters()), flax_to_state_dict(jst.g_params)),
             ("EMA-G", st.ema_g, flax_to_state_dict(jst.ema_g_params))]
    if gan:
        trees.append(("D", st.d_model.state_dict(), _d_state(jst.d_params, jst.d_vars)))
    for tree, ours, theirs in trees:
        assert set(ours) == set(theirs), tree
        for k in sorted(theirs):
            got, want = ours[k].detach().numpy(), np.asarray(theirs[k])
            assert got.dtype == want.dtype == np.float64, (tree, k)
            if tree == "D" and k == LOGIT_BIAS:
                assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-7 * cfg.model_lr, (got, want)
                continue
            off = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
            assert off <= (ROUNDOFF_BOUND.get(k, 1e-9) if tree == "D" else 1e-9), (tree, k, off)
    assert all(bias <= 1e-15 and weight > 1e-3 for bias, weight in logit_grads), logit_grads
    moved = max(float((st.g_model.state_dict()[k] - init[k]).abs().max()) for k in init)
    assert moved > 1e-5, f"suspiciously small G update {moved}"
    if gan:
        stats = [k for k in d_init if k.endswith(("running_mean", "running_var"))]
        assert len(stats) == 18
        assert all(not torch.equal(st.d_model.state_dict()[k], d_init[k]) for k in stats)
