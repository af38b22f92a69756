"""The port's ESRGAN modules against the JAX package's on the CPU: the
VGG-128 discriminator (``discriminator``) in training mode, with and
without ``update_stats``, and in eval mode; its weight bridge; the
``BatchNorm`` eval mode; the relativistic step's gradients; and the
``bicubic`` degradation adapter.

Inputs are made with numpy from a seed and handed to both frameworks;
weights are the JAX module's init, converted, with its BatchNorm scales,
biases and running statistics set away from 1 and 0 so that every mode
reads them. D at 8 channels (the 128 x 128 input is the module's only
size); G 16 channels, growth 8, 2 RRDBs. The f64 cases hold parameters
and running statistics in f64 in both frameworks, not only the compute:
gradients of f32 parameters come back rounded to f32.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu import configs as jax_configs
from srganfd_tpu.cli.degrade_adapter import DegradationAdapter as JaxAdapter
from srganfd_tpu.losses.gan import relativistic_d_loss as jax_rel_d
from srganfd_tpu.losses.gan import relativistic_g_loss as jax_rel_g
from srganfd_tpu.models import create_model as create_flax
from srganfd_tpu_torch import configs
from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
from srganfd_tpu_torch.convert import flax_to_state_dict, vgg_discriminator_flax_to_state_dict
from srganfd_tpu_torch.losses.gan import relativistic_d_loss
from srganfd_tpu_torch.models import create_model
from srganfd_tpu_torch.models.blocks import BatchNorm
from srganfd_tpu_torch.train.loop import Trainer
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

C = 8
SIZE = 128
DTYPES = {"float64": (jnp.float64, torch.float64), "float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODES = {"train_update": (True, True), "train": (True, False), "eval": (False, False)}  # (train, update_stats)
STATE = (".running_mean", ".running_var")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@functools.cache
def flax_vgg():
    """The tiny Flax D's f32 variables, its BatchNorm scales, biases and
    running statistics drawn away from their init, one input batch of two
    and one cotangent."""
    variables = jax.jit(create_flax("discriminator", channels=C).init)(
        jax.random.PRNGKey(5), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), variables)
    rng = np.random.default_rng(11)
    params, stats = dict(variables["params"]), dict(variables["batch_stats"])
    for name in [k for k in params if k.startswith("BatchNorm_")]:
        n = params[name]["scale"].shape[0]
        params[name] = {"scale": (1 + 0.2 * rng.normal(size=n)).astype(np.float32),
                        "bias": (0.1 * rng.normal(size=n)).astype(np.float32)}
        stats[name] = {"mean": (0.3 * rng.normal(size=n)).astype(np.float32),
                       "var": rng.uniform(0.5, 2.0, size=n).astype(np.float32)}
    x = rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    cot = rng.normal(size=(2, 1)).astype(np.float32)
    return {"params": params, "batch_stats": stats}, x, cot


@functools.cache
def flax_run(mode, dtype):
    """The Flax D's forward in ``mode`` and ``dtype`` (f32 parameters and
    statistics, as the package keeps them; f64 ones under f64) and, but
    for bf16, the gradients of the cotangent's projection with respect to
    the input and every parameter; the ``batch_stats`` it writes (its own,
    unwritten, without ``update_stats``), as the port's state dict."""
    variables, x, cot = flax_vgg()
    if dtype == "float64":
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    train, update_stats = MODES[mode]
    jdt = DTYPES[dtype][0]
    m = create_flax("discriminator", channels=C, dtype=jdt)

    def loss(p, xx):
        v = {"params": p, "batch_stats": variables["batch_stats"]}
        if train:
            out, new = m.apply(v, xx, train=True, mutable=["batch_stats"])
            stats = new["batch_stats"] if update_stats else variables["batch_stats"]
        else:
            out, stats = m.apply(v, xx, train=False), variables["batch_stats"]
        return jnp.sum(out.astype(jnp.float64) * cot), (out, stats)

    xj = jnp.asarray(x, jdt)
    if dtype == "bfloat16":
        _, (out, stats) = jax.jit(loss)(variables["params"], xj)
        grads = None
    else:
        (_, (out, stats)), (g_p, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            variables["params"], xj)
        grads = {"x": np.asarray(g_x), **{k: v for k, v in vgg_discriminator_flax_to_state_dict(
            g_p, variables["batch_stats"]).items() if not k.endswith(STATE)}}
    state = {k: v for k, v in vgg_discriminator_flax_to_state_dict(variables["params"], stats).items()
             if k.endswith(STATE)}
    return np.asarray(out, np.float64), grads, state


def _port(dtype):
    """The port's D on the converted variables: f32 parameters and running
    statistics, as the Flax module keeps them; f64 ones under f64."""
    variables = flax_vgg()[0]
    port = create_model("discriminator", channels=C, dtype=DTYPES[dtype][1])
    port.load_state_dict({k: _t(v) for k, v in vgg_discriminator_flax_to_state_dict(
        variables["params"], variables["batch_stats"]).items()})
    return port.double() if dtype == "float64" else port


# -- the VGG-128 discriminator ------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
def test_vgg_discriminator_matches_flax(mode, dtype):
    """The logit, the input's and every parameter's gradient and the
    running statistics, against the Flax module called with the same
    ``train`` (and the ``batch_stats`` it writes kept or not). f64: 1e-10
    of each tensor's largest entry; f32: 1e-5 (the gradients through nine
    BatchNorms: 1e-4). bf16 (forward and statistics): both frameworks round
    every layer's output to bf16 after summing in f32 in different orders,
    so the port is held to the JAX f32 logit no further than 2x the JAX
    bf16 logit is, and the statistics, summed in f32, to 1e-2 relative."""
    train, update_stats = MODES[mode]
    want_out, want_grads, want_state = flax_run(mode, dtype)
    port = _port(dtype)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    _, x, cot = flax_vgg()
    xt = _t(x).to(DTYPES[dtype][1]).requires_grad_()
    out = port(xt, update_stats=update_stats, train=train)
    assert tuple(out.shape) == (2, 1)
    assert out.dtype == (torch.float64 if dtype == "float64" else torch.float32)
    got_state = {k: v for k, v in port.state_dict().items() if k.endswith(STATE)}
    assert len(got_state) == 18
    if not update_stats:
        assert all(torch.equal(v, before[k]) for k, v in got_state.items())
    if dtype == "bfloat16":
        ref = flax_run(mode, "float32")[0]
        assert _rel(out.detach().float().numpy(), ref) <= 2 * max(_rel(want_out, ref), 2.0**-8)
        for k, w in want_state.items():
            assert _rel(got_state[k].numpy(), w) <= 1e-2, k
        return
    tol = 1e-10 if dtype == "float64" else 1e-5
    assert _rel(out.detach().numpy(), want_out) <= tol
    for k, w in want_state.items():
        assert _rel(got_state[k].numpy(), w) <= tol, k
    (out.double() * _t(cot).double()).sum().backward()
    grad_tol = 1e-10 if dtype == "float64" else 1e-4
    assert _rel(xt.grad.numpy(), want_grads["x"]) <= grad_tol
    got_grads = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert set(got_grads) == set(want_grads) - {"x"}
    for k, g in got_grads.items():
        assert _rel(g, want_grads[k]) <= grad_tol, (k, _rel(g, want_grads[k]))


def test_update_stats_needs_training_mode():
    with pytest.raises(ValueError, match="train=True"):
        _port("float32")(_t(flax_vgg()[1]), update_stats=True, train=False)


@pytest.mark.parametrize("size", [64, 130])
def test_vgg_discriminator_refuses_other_sizes(size):
    """The classifier reads a 4 x 4 map: the JAX module fails on a
    Dense shape there; the port says why."""
    with pytest.raises(ValueError, match="128 x 128"):
        create_model("discriminator", channels=C)(torch.rand(1, size, size, 3))


def test_bridge_keeps_the_flatten_order_of_classifier_0():
    """JAX transposes the 4 x 4 map to NCHW before it flattens, so
    ``Dense_0``'s rows are already torch's ``flatten(1)`` order and the
    bridge only transposes the kernel. The same weights with the rows taken
    in the NHWC order (a port that forgot the JAX transpose) give another
    function: it would train, and be wrong."""
    variables, x, _ = flax_vgg()
    want = flax_run("eval", "float32")[0]
    sd = {k: _t(v) for k, v in vgg_discriminator_flax_to_state_dict(
        variables["params"], variables["batch_stats"]).items()}
    w = sd["classifier.0.weight"]
    assert tuple(w.shape) == (100, 8 * C * 16)
    np.testing.assert_array_equal(w.numpy(), np.asarray(variables["params"]["Dense_0"]["kernel"]).T)
    port = create_model("discriminator", channels=C)
    port.load_state_dict(sd)
    assert _rel(port(_t(x)).detach().numpy(), want) <= 1e-5
    hwc = w.reshape(100, 8 * C, 4, 4).permute(0, 2, 3, 1).reshape(100, -1)  # rows in (h, w, c) order
    port.load_state_dict({**sd, "classifier.0.weight": hwc})
    assert _rel(port(_t(x)).detach().numpy(), want) > 1e-2


def test_bridge_refuses_other_trees():
    variables = flax_vgg()[0]
    params = dict(variables["params"])
    params["Conv_10"] = params["Conv_9"]
    with pytest.raises(ValueError, match="VGG-128"):
        vgg_discriminator_flax_to_state_dict(params, variables["batch_stats"])
    stats = {k: v for k, v in variables["batch_stats"].items() if k != "BatchNorm_8"}
    with pytest.raises(ValueError, match="VGG-128"):
        vgg_discriminator_flax_to_state_dict(variables["params"], stats)


def test_vgg_discriminator_init_is_flax_lecun_normal():
    """At the config's width (c = 64): every conv and Linear weight is
    lecun-normal as Flax draws it (variance 1/fan_in, truncated at two
    standard deviations of the untruncated normal), biases zero, BatchNorm
    scale 1 and bias 0, running mean 0 and variance 1; the Flax init has
    the same per-layer spread; one seed gives one D."""
    port = create_model("discriminator", generator=torch.Generator().manual_seed(0))
    sd = port.state_dict()
    jax_params = jax.jit(create_flax("discriminator").init)(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    jax_sd = vgg_discriminator_flax_to_state_dict(jax_params["params"], jax_params["batch_stats"])
    weights = [k for k in sd if k.endswith(".weight") and sd[k].dim() > 1]
    assert len(weights) == 12
    for k in weights:
        w = sd[k]
        fan_in = w[0].numel()
        std = w.std().item() * fan_in**0.5
        assert abs(std - 1) < (0.1 if w.numel() < 5000 else 0.02), (k, std)
        assert w.abs().max().item() <= 2 / 0.87962566103423978 / fan_in**0.5 * (1 + 1e-6), k
        jax_std = float(np.std(jax_sd[k])) * fan_in**0.5
        assert abs(std - jax_std) < (0.15 if w.numel() < 5000 else 0.03), (k, std, jax_std)
    for k, v in sd.items():
        if k.endswith(".bias") or k.endswith("running_mean"):
            assert torch.equal(v, torch.zeros_like(v)), k
        elif k.endswith("running_var") or (k.endswith(".weight") and v.dim() == 1):
            assert torch.equal(v, torch.ones_like(v)), k
    again = create_model("discriminator", generator=torch.Generator().manual_seed(0)).state_dict()
    other = create_model("discriminator", generator=torch.Generator().manual_seed(1)).state_dict()
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    assert not torch.equal(other["features.0.weight"], sd["features.0.weight"])


# -- BatchNorm's eval mode -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_eval_mode_matches_flax(dtype):
    """Flax ``nn.BatchNorm(use_running_average=True)``: the running mean and
    variance normalise, nothing is written, and the gradient reaches the
    input, scale and bias (not the statistics). f32 to 1e-6 of the largest
    value; bf16 within one bf16 ulp of it."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(8)
    x = (1.0 + 2.0 * rng.normal(size=(3, 4, 5, 6))).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    scale, bias = (1 + 0.2 * rng.normal(size=6)).astype(np.float32), (0.1 * rng.normal(size=6)).astype(np.float32)
    stats = {"mean": (0.5 * rng.normal(size=6)).astype(np.float32), "var": rng.uniform(0.5, 2, size=6).astype(np.float32)}
    bn = nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5, dtype=jdt, param_dtype=jnp.float32)

    def loss(p, xx):
        out = bn.apply({"params": p, "batch_stats": stats}, xx)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, want), (g_p, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        {"scale": scale, "bias": bias}, jnp.asarray(x, jdt))
    port = BatchNorm(6)
    port.load_state_dict({"weight": _t(scale), "bias": _t(bias), "running_mean": _t(stats["mean"]),
                          "running_var": _t(stats["var"])})
    xt = _t(x).to(tdt).permute(0, 3, 1, 2).detach().requires_grad_()
    got = port(xt, train=False)
    assert got.dtype == tdt
    np.testing.assert_array_equal(port.running_mean.numpy(), stats["mean"])
    np.testing.assert_array_equal(port.running_var.numpy(), stats["var"])
    (got.float().permute(0, 2, 3, 1) * _t(cot)).sum().backward()
    got = got.detach().float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        assert _rel(got, want) <= 1e-6
        assert _rel(xt.grad.permute(0, 2, 3, 1).numpy(), g_x) <= 1e-6
        for name, jname in (("weight", "scale"), ("bias", "bias")):
            assert _rel(getattr(port, name).grad.numpy(), g_p[jname]) <= 1e-6, name
    else:
        assert np.abs(got - want).max() <= 2.0**-8 * np.abs(want).max()


# -- the relativistic step's gradients --------------------------------------------------------


def test_relativistic_step_gradients_match_jax(monkeypatch):
    """One ``esrgan`` step of the port's Trainer (all in f64, content loss off),
    with what each Adam is handed recorded: G's gradient against
    ``jax.grad`` of the pixel term plus ``relativistic_g_loss`` with D(gt)
    under ``stop_gradient`` (D as the step finds it: G goes first), and
    D's against ``jax.grad`` of ``relativistic_d_loss(D(gt), D(sr))``
    through both means, on the SR that G made before its update; both to
    1e-10 per tensor. D's gradient holds nothing of the G term's. A port
    that detached either mean would read D's gradient more than 1e-3
    off."""
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), flax_vgg()[0])
    tiny_g = {"channels": 16, "growth_channels": 8, "num_blocks": 2}
    over = dict(compute_dtype="float64", content_weight=(), g_kwargs=tiny_g, d_kwargs={"channels": C})
    jcfg = jax_configs.get_config("esrgan", **over)
    g_flax = create_flax("rrdbnet_x4", dtype=jnp.float64, **tiny_g)
    d_flax = create_flax("discriminator", channels=C, dtype=jnp.float64)
    rng = np.random.default_rng(12)
    gt = rng.uniform(size=(2, SIZE, SIZE, 3))
    lr = rng.uniform(size=(2, SIZE // 4, SIZE // 4, 3))
    g_params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), g_flax.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 8, 8, 3))))["params"]

    def d_apply(p, xx):
        out, _ = d_flax.apply({"params": p, "batch_stats": variables["batch_stats"]}, xx, train=True,
                              mutable=["batch_stats"])
        return out

    sr = jax.jit(g_flax.apply)({"params": g_params}, lr)

    def g_loss(gp):
        s = g_flax.apply({"params": gp}, lr)
        adv = jax_rel_g(jax.lax.stop_gradient(d_apply(variables["params"], gt)), d_apply(variables["params"], s))
        w = jnp.asarray(jcfg.pixel_weight + jcfg.adversarial_weight, jnp.float32)  # as the trainers weigh
        return w[0] * jnp.mean(jnp.abs(s - gt)) + w[1] * adv

    want_g = flax_to_state_dict(jax.jit(jax.grad(g_loss))(g_params))
    want_d = vgg_discriminator_flax_to_state_dict(jax.jit(jax.grad(lambda dp: jax_rel_d(
        d_apply(dp, gt), d_apply(dp, sr))))(variables["params"]), variables["batch_stats"])

    tr = Trainer(configs.get_config("esrgan", **over), steps_per_epoch=1)
    st = tr.init_state({k: _t(v) for k, v in flax_to_state_dict(g_params).items()},
                       {k: _t(v) for k, v in vgg_discriminator_flax_to_state_dict(
                           variables["params"], variables["batch_stats"]).items()})
    st.g_model.double()
    st.d_model.double()
    seen = {}
    for name, model, opt in (("g", st.g_model, st.g_opt), ("d", st.d_model, st.d_opt)):
        real = opt.step

        def recorded(*a, name=name, model=model, real=real, **kw):
            seen[name] = {k: p.grad.clone() for k, p in model.named_parameters()}
            return real(*a, **kw)

        monkeypatch.setattr(opt, "step", recorded)
    tr.train_step(st, _t(gt), _t(lr))
    for name, want in (("g", want_g), ("d", want_d)):
        got = seen[name]
        assert set(got) == {k for k in want if not k.endswith(STATE)}
        for k, g in got.items():
            assert _rel(g.numpy(), want[k]) <= 1e-10, (name, k, _rel(g.numpy(), want[k]))

    # the same D gradient with the means detached: visibly another function
    d = create_model("discriminator", channels=C, dtype=torch.float64).double()
    d.load_state_dict({k: _t(v) for k, v in vgg_discriminator_flax_to_state_dict(
        variables["params"], variables["batch_stats"]).items()})
    real_out, fake_out = d(_t(gt), train=True), d(_t(np.asarray(sr)), train=True)
    relativistic_d_loss(real_out, fake_out).backward(retain_graph=True)
    full = {k: p.grad.clone() for k, p in d.named_parameters()}
    d.zero_grad()
    relativistic_d_loss(real_out, fake_out.detach().requires_grad_()).backward(retain_graph=True)
    real_only = {k: p.grad.clone() for k, p in d.named_parameters()}
    assert all(_rel(full[k].numpy(), want_d[k]) <= 1e-10 for k in full)
    assert max(_rel(real_only[k].numpy(), want_d[k]) for k in full) > 1e-3


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_relativistic_d_loss_gives_the_logit_bias_no_gradient(dtype):
    """The logit's bias (``classifier.2.bias``) cancels from both logit
    differences of ``relativistic_d_loss``, so its gradient is the roundoff
    of a sum that is 0: below 1e-15 in f64, and below the 1e-6 that
    chip_smoke's f32 ``esrgan`` check holds it to in f32. With the SR
    branch detached it is half a BCE mean's, far above."""
    rng = np.random.default_rng(13)
    gt, sr = (_t(rng.uniform(size=(4, SIZE, SIZE, 3))).to(DTYPES[dtype][1]) for _ in range(2))
    d = _port(dtype)
    real_out, fake_out = d(gt, train=True), d(sr, train=True)
    relativistic_d_loss(real_out, fake_out).backward(retain_graph=True)
    bias = d.classifier[2].bias
    assert abs(bias.grad.item()) <= (1e-15 if dtype == "float64" else 1e-6)
    assert d.classifier[2].weight.grad.abs().max().item() > 1e-3
    bias.grad = None
    relativistic_d_loss(real_out, fake_out.detach()).backward()
    assert abs(bias.grad.item()) > 1e-2


# -- the bicubic degradation -----------------------------------------------------------------


@pytest.mark.parametrize("source", ["uint8", "float32"])
def test_bicubic_adapter_matches_jax_bicubic_pair(source):
    """``rrdbnet``'s ``bicubic`` adapter on one batch, uint8 (scaled by
    1/255) or the loader's float32 [0, 1]: GT exactly, LR (MATLAB bicubic
    x1/4, clipped) to 1e-6, in training and evaluation alike."""
    rng = np.random.default_rng(9)
    gt = rng.integers(0, 256, size=(2, 48, 40, 3), dtype=np.uint8)
    host = {"gt": gt if source == "uint8" else (gt / 255.0).astype(np.float32)}
    cfg, jcfg = configs.get_config("rrdbnet"), jax_configs.get_config("rrdbnet")
    for train in (True, False):
        got = DegradationAdapter(cfg, seed=0, train=train)(host, 3)
        want = JaxAdapter(jcfg, seed=0, train=train)(host, 3)
        assert set(got) == {"gt", "lr"}
        assert got["gt"].dtype == got["lr"].dtype == torch.float32
        assert tuple(got["lr"].shape) == (2, 12, 10, 3)
        np.testing.assert_allclose(got["gt"].numpy(), np.asarray(want["gt"]), rtol=0, atol=1e-7)
        np.testing.assert_allclose(got["lr"].numpy(), np.asarray(want["lr"]), rtol=0, atol=1e-6)
        assert got["lr"].min() >= 0 and got["lr"].max() <= 1
