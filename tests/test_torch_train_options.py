"""The trainer's numerical options in the port's ``Trainer`` against the JAX
package's: gradient accumulation, the global-norm clip, AdamW's decoupled
weight decay and the non-finite guard.

An f64 lockstep from one converted state, parameters, Adams and EMA-G in
f64 in both trainers (``tests/test_torch_esrgan_lockstep.py`` says why f32
parameters cannot be held to 1e-9 across frameworks), held to 1e-9 of each
tensor's largest entry: ``bsrgan`` (the D step first, spectral-norm U-Net
D) with ``grad_accum_steps=2``, ``grad_clip_norm``,
``model_weight_decay=0.01`` and ``skip_nonfinite_updates`` over three
steps, the second on a batch with a NaN pixel: both updates skip, and the
third step's schedules and Adam bias corrections run on the applied-update
count. The content loss is off (VGG19 computes in f32 under f64 compute;
``tests/test_torch_gan_lockstep.py`` holds it). Inputs are made with numpy
from a seed. ``tests/test_torch_esrgan_accum_lockstep.py`` holds the G-first
step's accumulation.

Then the guard's own contract on the port: a skipped phase leaves every
tensor bit for bit, a guarded finite step equals an unguarded one bit for
bit; and the clip against optax's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu import configs as jax_configs
from srganfd_tpu.train.loop import Trainer as JaxTrainer
from srganfd_tpu_torch import configs
from srganfd_tpu_torch.convert import discriminator_flax_to_state_dict, flax_to_state_dict
from srganfd_tpu_torch.train import loop
from srganfd_tpu_torch.train.loop import Trainer
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TINY_G = {"channels": 16, "growth_channels": 8, "num_rrdb": 1}
BSRGAN = dict(compute_dtype="float64", epochs=4, g_kwargs=TINY_G, d_kwargs={"channels": 8}, content_weight=(),
              grad_accum_steps=2, grad_clip_norm=0.05, model_weight_decay=0.01, skip_nonfinite_updates=True)
# D tensors whose gradient is the roundoff of a zero sum in the relativistic
# step (tests/test_torch_esrgan_lockstep.py): the logit's bias, held by value,
# and classifier.0's bias, held to 1e-8
LOGIT_BIAS = "classifier.2.bias"
ROUNDOFF_BOUND = {"classifier.0.bias": 1e-8}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _jax_state_in_f64(jtr, jst):
    g, d = _f64(jst.g_params), _f64(jst.d_params)
    return jst.replace(g_params=g, g_opt_state=jtr.g_tx.init(g), ema_g_params=_f64(jst.ema_g_params),
                       d_params=d, d_opt_state=jtr.d_tx.init(d), d_vars=_f64(jst.d_vars))


def _port_state_in_f64(st, init, d_init):
    """The port's state in f64, loaded again after the conversion: x64 JAX
    draws ``u`` in f64, which an f32 module would round."""
    st.g_model.double().load_state_dict(init)
    st.ema_g = {k: v.double() for k, v in init.items()}
    st.d_model.double().load_state_dict(d_init)
    return st


def _held(trees, lr):
    for tree, ours, theirs in trees:
        assert set(ours) == set(theirs), tree
        for k in sorted(theirs):
            got, want = ours[k].detach().numpy(), np.asarray(theirs[k])
            assert got.dtype == want.dtype == np.float64, (tree, k)
            if tree == "D" and k == LOGIT_BIAS:
                assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-7 * lr, (got, want)
                continue
            off = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
            assert off <= (ROUNDOFF_BOUND.get(k, 1e-9) if tree == "D" else 1e-9), (tree, k, off)


def _adam_steps(opt) -> set[float]:
    return {float(s["step"]) for s in opt.state.values()}


def test_bsrgan_options_lockstep_with_jax_trainer(monkeypatch):
    """Three ``bsrgan`` steps, batch 4 in two chunks, the clip at 0.05 (it
    cuts G's and D's norms at every applied step: recorded below), AdamW at
    wd 0.01; step 1's LR holds a NaN. Held: the losses and probabilities
    (NaN where JAX's are) to 1e-9, both skip flags, the learning rates, the
    applied-update counts (2 of 3) and the Adams' ``step``, G, EMA-G, D
    and ``u`` to 1e-9. One step per epoch over 4 epochs puts both
    milestones at step 2, so the third update runs at the lr of count 1,
    where the step, 2, would give 0.85^2 of it."""
    n_steps, batch, gt_size = 3, 4, 32
    jtr = JaxTrainer(jax_configs.get_config("bsrgan", **BSRGAN), steps_per_epoch=1)
    jst = _jax_state_in_f64(jtr, jax.jit(jtr.init_state, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), (batch, gt_size // 2, gt_size // 2, 3), (batch, gt_size, gt_size, 3)))
    cfg = configs.get_config("bsrgan", **BSRGAN)
    rng = np.random.default_rng(3)
    gts = rng.uniform(size=(n_steps, batch, gt_size, gt_size, 3)).astype(np.float32)
    lrs = np.ascontiguousarray(gts[:, :, ::2, ::2, :])
    lrs[1, 2, 3, 5, 1] = np.nan

    init = {k: _t(v) for k, v in flax_to_state_dict(jst.g_params).items()}
    d_init = {k: _t(v) for k, v in discriminator_flax_to_state_dict(jst.d_params, jst.d_vars["spectral"]).items()}
    tr = Trainer(cfg, steps_per_epoch=1)
    st = _port_state_in_f64(tr.init_state(init, d_init), init, d_init)
    assert isinstance(st.g_opt, torch.optim.AdamW) and st.g_opt.defaults["weight_decay"] == 0.01
    norms = []
    real_clip = loop._clip_by_global_norm

    def recorded_clip(grads, max_norm):
        norms.append(float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))))
        real_clip(grads, max_norm)

    monkeypatch.setattr(loop, "_clip_by_global_norm", recorded_clip)
    keys = ("d_loss", "d_gt_probability", "d_sr_probability", "d_update_skipped", "pixel_loss",
            "adversarial_loss", "g_loss", "g_update_skipped")
    jax_metrics, metrics, lrs_used, counts = [], [], [], []
    for i in range(n_steps):
        jst, m = jtr.train_step(jst, jnp.asarray(gts[i]), jnp.asarray(lrs[i]))
        jax_metrics.append([float(m[k]) for k in keys])
        out = tr.train_step(st, _t(gts[i]), _t(lrs[i]))
        assert set(out) == set(keys)
        metrics.append([float(out[k]) for k in keys])
        lrs_used.append((st.g_opt.param_groups[0]["lr"], st.d_opt.param_groups[0]["lr"]))
        counts.append((st.g_count, st.d_count))
    np.testing.assert_allclose(metrics, jax_metrics, rtol=1e-9, atol=0)
    skipped = [(m[keys.index("g_update_skipped")], m[keys.index("d_update_skipped")]) for m in metrics]
    assert skipped == [(0.0, 0.0), (1.0, 1.0), (0.0, 0.0)]
    assert np.isnan(metrics[1][keys.index("g_loss")])
    # by the step, the third update would run at 0.85^2 of these
    assert lrs_used == [(8e-5, 2e-4)] * 3
    assert counts == [(1, 1), (1, 1), (2, 2)] and st.step == 3
    assert _adam_steps(st.g_opt) == _adam_steps(st.d_opt) == {2.0}
    assert len(norms) == 4 and min(norms) > cfg.grad_clip_norm, norms  # two applied phases a step, all clipped
    _held([("G", dict(st.g_model.named_parameters()), flax_to_state_dict(jst.g_params)),
           ("EMA-G", st.ema_g, flax_to_state_dict(jst.ema_g_params)),
           ("D", st.d_model.state_dict(), discriminator_flax_to_state_dict(jst.d_params, jst.d_vars["spectral"]))],
          cfg.model_lr)
    moved = max(float((st.g_model.state_dict()[k] - init[k]).abs().max()) for k in init)
    assert moved > 1e-5, f"suspiciously small G update {moved}"


def _tiny_bsrgan(**over):
    cfg = configs.get_config("bsrgan", compute_dtype="float32", g_kwargs={"channels": 8, "growth_channels": 4,
                             "num_rrdb": 1}, d_kwargs={"channels": 8}, content_weight=(), **over)
    tr = Trainer(cfg, steps_per_epoch=4)
    return tr, tr.init_state()


def _snapshot(st) -> dict:
    return {
        "g": copy.deepcopy(st.g_model.state_dict()), "d": copy.deepcopy(st.d_model.state_dict()),
        "g_opt": copy.deepcopy(st.g_opt.state_dict()), "d_opt": copy.deepcopy(st.d_opt.state_dict()),
        "ema": {k: v.clone() for k, v in st.ema_g.items()}, "counts": (st.g_count, st.d_count),
    }


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def _batch(seed: int, inf: bool = False):
    rng = np.random.default_rng(seed)
    gt = torch.from_numpy(rng.uniform(size=(2, 32, 32, 3)).astype(np.float32))
    lr = gt[:, ::2, ::2].contiguous()
    if inf:
        lr[1, 4, 4, 0] = float("inf")
    return gt, lr


def test_a_skipped_step_leaves_the_state_bit_for_bit():
    """An Inf pixel: both phases skip, and G, D (its ``u``, which the D
    phase's forwards wrote before the check), both Adams (``step`` too),
    EMA-G and the counts are as before; ``state.step`` advances, as the JAX
    state's does. The next finite step equals that step from the saved
    state."""
    tr, st = _tiny_bsrgan(skip_nonfinite_updates=True)
    tr.train_step(st, *_batch(0))
    before = _snapshot(st)
    out = tr.train_step(st, *_batch(1, inf=True))
    assert float(out["g_update_skipped"]) == float(out["d_update_skipped"]) == 1.0
    assert _equal(_snapshot(st), before) and st.step == 2

    twin_tr, twin = _tiny_bsrgan(skip_nonfinite_updates=True)
    twin.g_model.load_state_dict(before["g"])
    twin.d_model.load_state_dict(before["d"])
    twin.g_opt.load_state_dict(copy.deepcopy(before["g_opt"]))
    twin.d_opt.load_state_dict(copy.deepcopy(before["d_opt"]))
    for k, v in before["ema"].items():
        twin.ema_g[k].copy_(v)
    twin.step, (twin.g_count, twin.d_count) = 1, before["counts"]
    batch = _batch(2)
    tr.train_step(st, *batch)
    twin_tr.train_step(twin, *batch)
    assert _equal(_snapshot(st), _snapshot(twin))


def test_a_guarded_finite_step_equals_an_unguarded_one():
    guarded_tr, guarded = _tiny_bsrgan(skip_nonfinite_updates=True)
    plain_tr, plain = _tiny_bsrgan()
    for seed in (0, 1):
        out = guarded_tr.train_step(guarded, *_batch(seed))
        plain_out = plain_tr.train_step(plain, *_batch(seed))
        assert float(out["g_update_skipped"]) == 0.0 and "g_update_skipped" not in plain_out
    assert _equal(_snapshot(guarded), _snapshot(plain))


def test_grad_accum_needs_a_batch_it_divides():
    tr, st = _tiny_bsrgan(grad_accum_steps=3)
    with pytest.raises(ValueError, match="batch 2 not divisible by grad_accum_steps 3"):
        tr.train_step(st, *_batch(0))


@pytest.mark.parametrize("scale", [0.5, 2.0], ids=["below", "above"])
def test_clip_is_optax_clip_by_global_norm(scale):
    """``g * max / |g|`` where the global norm reaches ``max``, ``g`` as it
    is below: optax's own function on the same gradients, f64."""
    import optax

    rng = np.random.default_rng(5)
    grads = [rng.standard_normal(s) for s in ((3, 4), (5,), (2, 2, 2))]
    norm = float(np.sqrt(sum((g**2).sum() for g in grads)))
    want, _ = optax.clip_by_global_norm(norm * scale).update([jnp.asarray(g) for g in grads], None)
    ours = [torch.from_numpy(g.copy()) for g in grads]
    loop._clip_by_global_norm(ours, norm * scale)
    for o, w, g in zip(ours, want, grads):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-15, atol=0)
        assert (scale < 1) != np.array_equal(o.numpy(), g)


def test_nonfinite_check_sees_nan_and_inf():
    ok = [torch.ones(3), torch.zeros(2, 2)]
    assert loop._all_finite(ok)
    for bad in (float("nan"), float("inf"), -float("inf")):
        assert not loop._all_finite([ok[0], torch.tensor([0.0, bad])])
