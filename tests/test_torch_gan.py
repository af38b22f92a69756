"""The port's GAN stage against the JAX package's on the CPU: the
spectral-norm conv, the bilinear resize, the U-Net discriminator, the
adversarial losses, the VGG19 content loss and LPIPS (the lockstep
steps of the two trainers are ``test_torch_gan_lockstep.py``, the configs
``test_torch_train.py``'s).

Inputs are made with numpy from a seed and handed to both frameworks;
weights are the JAX modules' (surrogates included), converted. Tiny
widths: D 8 channels; the VGG19 on 32 x 32 (its deepest node,
``features.34``, at 2 x 2).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu.losses import gan as jax_gan_losses
from srganfd_tpu.losses.content import ContentLoss as JaxContentLoss
from srganfd_tpu.losses.content import VGG19Features as JaxVGG19Features
from srganfd_tpu.losses.content import load_vgg19_params as jax_load_vgg19_params
from srganfd_tpu.losses.lpips import Lpips as JaxLpips
from srganfd_tpu.models import create_model as create_flax
from srganfd_tpu.models.blocks import SNConv as FlaxSNConv
from srganfd_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from srganfd_tpu_torch.convert import (
    alexnet_flax_to_state_dict,
    discriminator_flax_to_state_dict,
    vgg19_flax_to_state_dict,
)
from srganfd_tpu_torch.losses import gan
from srganfd_tpu_torch.losses.content import ContentLoss, load_vgg19_params
from srganfd_tpu_torch.losses.lpips import Lpips, load_lpips_params
from srganfd_tpu_torch.models import create_model
from srganfd_tpu_torch.models.blocks import SNConv
from srganfd_tpu_torch.ops.resize import resize_bilinear
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TINY_G = {"channels": 16, "growth_channels": 8, "num_rrdb": 2}
TINY_D = {"channels": 8}
BSRGAN_NODES = ("features.2", "features.7", "features.16", "features.25", "features.34")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the spectral-norm conv ---------------------------------------------------------


@pytest.mark.parametrize("update_stats", [True, False], ids=["update", "no_update"])
@pytest.mark.parametrize("kernel,stride", [(4, 2), (3, 1)], ids=["k4s2", "k3s1"])
def test_snconv_matches_flax(kernel, stride, update_stats):
    """The output, sigma and the written ``u``; ``update_stats=False``
    leaves ``u`` as it was."""
    rng = np.random.default_rng(kernel)
    x = rng.normal(size=(2, 12, 12, 6)).astype(np.float32)
    flax_conv = FlaxSNConv(10, kernel=kernel, stride=stride, padding=1)
    variables = jax.jit(flax_conv.init)(jax.random.PRNGKey(kernel), jnp.asarray(x))
    want, new = jax.jit(functools.partial(flax_conv.apply, update_stats=update_stats, mutable=["spectral"]))(
        variables, jnp.asarray(x))
    # u is f64 here: the tests run JAX with x64 on, and jax.random.normal
    # then draws f64 (the port keeps u in f32)
    k, u = variables["params"]["kernel"], np.asarray(variables["spectral"]["u"], np.float32)

    port = SNConv(6, 10, kernel, stride)
    port.load_state_dict({"weight": _t(np.transpose(k, (3, 2, 0, 1))), "u": _t(u)})
    sigma = port.sigma(update_stats=False).item()
    assert torch.equal(port.u, _t(u))
    got = port(_t(x).permute(0, 3, 1, 2), update_stats=update_stats).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    # the Flax output is conv(x, k) / sigma: its sigma by least squares
    raw = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), k, (stride, stride), ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC")))
    flax_sigma = float(np.sum(raw * raw) / np.sum(raw * np.asarray(want)))
    assert abs(sigma - flax_sigma) <= 1e-5 * flax_sigma, (sigma, flax_sigma)

    np.testing.assert_allclose(port.u.numpy(), np.asarray(new["spectral"]["u"]), rtol=1e-5, atol=1e-6)
    if not update_stats:
        assert torch.equal(port.u, _t(u))


def test_snconv_gradient_flows_through_sigma():
    """d(out)/dW includes the -W/sigma^2 dsigma/dW term (u', v constants),
    as ``jax.grad`` through the Flax module does."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    cot = rng.normal(size=(1, 4, 4, 6)).astype(np.float32)
    flax_conv = FlaxSNConv(6, kernel=4, stride=2, padding=1)
    variables = jax.jit(flax_conv.init)(jax.random.PRNGKey(1), jnp.asarray(x))

    def loss(params):
        out = flax_conv.apply({"params": params, "spectral": variables["spectral"]}, jnp.asarray(x))
        return jnp.sum(out * cot)

    want = np.transpose(np.asarray(jax.jit(jax.grad(loss))(variables["params"])["kernel"]), (3, 2, 0, 1))
    port = SNConv(4, 6, 4, 2)
    port.load_state_dict({"weight": _t(np.transpose(variables["params"]["kernel"], (3, 2, 0, 1))),
                          "u": _t(variables["spectral"]["u"])})
    (port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1) * _t(cot)).sum().backward()
    np.testing.assert_allclose(port.weight.grad.numpy(), want, rtol=1e-4, atol=1e-6)


# -- the bilinear resize the D's decoder differentiates through -------------------------


@pytest.mark.parametrize("in_hw,out_hw", [((5, 7), (10, 14)), ((9, 6), (4, 11))], ids=["x2", "ragged"])
def test_resize_bilinear_gradient_matches_jax(in_hw, out_hw):
    """The value and the gradient of a random projection, against
    ``jax.grad`` through the JAX resize (half-pixel centers)."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(2, *in_hw, 3)).astype(np.float32)
    cot = rng.normal(size=(2, *out_hw, 3)).astype(np.float32)
    want, want_grad = jax.value_and_grad(
        lambda a: jnp.sum(jax_resize_bilinear(a, out_hw, half_pixel=True) * cot))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    got = (resize_bilinear(xt, out_hw) * _t(cot)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-6)


# -- the U-Net discriminator -----------------------------------------------------------


@pytest.fixture(scope="module")
def flax_d():
    """The tiny Flax D's variables, and per dtype its train-mode forward on
    one input with the gradients of a random projection of the logit map
    with respect to the input and every parameter, through
    ``jax.value_and_grad``."""
    variables = jax.jit(create_flax("discriminator_unet", **TINY_D).init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3), jnp.float32))
    rng = np.random.default_rng(11)
    x = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    cot = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    results = {}
    for dtype, (jdt, _) in DTYPES.items():
        model = create_flax("discriminator_unet", dtype=jdt, **TINY_D)

        def loss(p, xx, model=model):
            out, new = model.apply({"params": p, "spectral": variables["spectral"]}, xx, train=True,
                                   mutable=["spectral"])
            return jnp.sum(out * cot), (out, new["spectral"])

        (_, (out, u)), (g_params, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            variables["params"], jnp.asarray(x))
        results[dtype] = {"out": np.asarray(out), "x": np.asarray(g_x),
                          **discriminator_flax_to_state_dict(g_params, variables["spectral"]),
                          **{k: v for k, v in discriminator_flax_to_state_dict(variables["params"], u).items()
                             if k.endswith(".u")}}
    return variables, x, cot, results


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_discriminator_unet_forward_and_grads_match_flax(flax_d, dtype):
    """A train-mode forward (``u`` advanced) and the gradients of a random
    projection of its logit map, against the Flax D. f32: to 1e-5 of the
    largest value (1e-4 for the parameters' gradients, sums of more
    terms). bf16: the two frameworks round different sums, so each is held
    to the JAX f32 result, the port no further from it than 1.5x the JAX
    bf16 result is."""
    variables, x, cot, results = flax_d
    port = create_model("discriminator_unet", dtype=DTYPES[dtype][1], **TINY_D)
    port.load_state_dict({k: _t(v) for k, v in discriminator_flax_to_state_dict(
        variables["params"], variables["spectral"]).items()})
    xt = _t(x).requires_grad_()
    out = port(xt, update_stats=True)
    assert out.dtype == torch.float32 and out.shape == (2, 32, 32, 1)
    (out * _t(cot)).sum().backward()
    got = {"out": out.detach().numpy(), "x": xt.grad.numpy(),
           **{k: p.grad.numpy() for k, p in port.named_parameters()},
           **{k: b.numpy() for k, b in port.named_buffers()}}
    assert set(got) == set(results[dtype])
    for name, want in results[dtype].items():
        if name.endswith(".u"):  # the power iteration runs in f32 at either compute dtype
            np.testing.assert_allclose(got[name], want, rtol=1e-5, atol=1e-6, err_msg=name)
        elif dtype == "float32":
            assert _rel(got[name], want) <= (1e-5 if name in ("out", "x") else 1e-4), name
        else:
            ref = results["float32"][name]
            assert _rel(got[name], ref) <= 1.5 * _rel(want, ref), (name, _rel(got[name], ref), _rel(want, ref))


def test_discriminator_mapping_refuses_other_trees(flax_d):
    variables = flax_d[0]
    params = dict(variables["params"])
    params["Conv_2"] = params["Conv_1"]
    with pytest.raises(ValueError, match="discriminator_unet"):
        discriminator_flax_to_state_dict(params, variables["spectral"])


# -- adversarial losses -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["bce", "relativistic_d", "relativistic_g"])
def test_adversarial_losses_match_jax(which, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(12)
    real = (4 * rng.normal(size=(2, 8, 8, 1))).astype(np.float32)
    fake = (4 * rng.normal(size=(2, 8, 8, 1))).astype(np.float32)
    targets = rng.uniform(size=real.shape).astype(np.float32)
    pairs = {
        "bce": (jax_gan_losses.bce_with_logits, gan.bce_with_logits, (real, targets)),
        "relativistic_d": (jax_gan_losses.relativistic_d_loss, gan.relativistic_d_loss, (real, fake)),
        "relativistic_g": (jax_gan_losses.relativistic_g_loss, gan.relativistic_g_loss, (real, fake)),
    }
    jax_fn, fn, (a, b) = pairs[which]
    want, want_grad = jax.jit(jax.value_and_grad(jax_fn))(jnp.asarray(a, jdt), jnp.asarray(b, jdt))
    at = _t(a).to(tdt).requires_grad_()
    got = fn(at, _t(b).to(tdt))
    assert got.dtype == torch.float32
    got.backward()
    # bf16: the relativistic losses take the mean of bf16 logits in bf16, and
    # the two frameworks may round it one ulp apart (2^-8 relative); the
    # gradient is rounded to bf16 too, one ulp of its largest value apart
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6 if dtype == "float32" else 2**-8)
    assert _rel(at.grad.float().numpy(), want_grad) <= (1e-6 if dtype == "float32" else 2**-7)


# -- the VGG19 content loss -------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_vgg():
    """The JAX content loss of the bsrgan config (five nodes, weight 1.0)
    on the JAX surrogate VGG19 (``PRNGKey(42)``)."""
    return JaxContentLoss(nodes=BSRGAN_NODES, weights=(1.0,))


@pytest.fixture(scope="module")
def jax_content(jax_vgg):
    """Inputs, and per dtype the JAX content loss's ``per_node`` and the
    gradient of the weighted sum with respect to SR."""
    rng = np.random.default_rng(13)
    sr = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    gt = np.clip(sr + 0.1 * rng.normal(size=sr.shape), 0, 1).astype(np.float32)
    readings = {}
    for dtype, (jdt, _) in DTYPES.items():
        loss = copy.copy(jax_vgg)
        loss.module = JaxVGG19Features(nodes=BSRGAN_NODES, dtype=jdt)

        def total(s, loss=loss):
            per_node = loss.per_node(s, jnp.asarray(gt))
            return jnp.sum(loss.weights * per_node), per_node

        (_, per_node), grad = jax.jit(jax.value_and_grad(total, has_aux=True))(jnp.asarray(sr))
        readings[dtype] = (np.asarray(per_node), np.asarray(grad))
    return sr, gt, readings


@pytest.mark.parametrize("detach_bug", [False, True], ids=["gradients", "detach_bug"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_content_loss_per_node_and_gradient_match_jax(jax_vgg, jax_content, dtype, detach_bug):
    """``per_node``, the weighted sum and its gradient with respect to SR.
    f32: per node to 1e-5 (the JAX package sums each node's mean in f32
    sequentially, ~5e-6 off the exact sum at features.2), the gradient to
    1e-5 of its largest value. bf16: held to the JAX f32 result, the port
    no further from it than 1.5x the JAX bf16 result is. ``detach_bug``
    (the reference's ``torch.Tensor([losses])``) keeps the values and
    stops the gradient, as ``jax.lax.stop_gradient`` does in JAX."""
    sr, gt, readings = jax_content
    want, want_grad = readings[dtype]
    loss = ContentLoss(BSRGAN_NODES, (1.0,), detach_bug=detach_bug, dtype=DTYPES[dtype][1])
    loss.module.load_state_dict(
        {k: _t(v) for k, v in vgg19_flax_to_state_dict(jax_vgg.variables["params"]).items()})
    srt = _t(sr).requires_grad_()
    per_node = loss.per_node(srt, _t(gt))
    assert per_node.shape == (5,) and per_node.dtype == torch.float32
    total = loss(srt, _t(gt))
    got = per_node.detach().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(total.item(), want.sum(), rtol=1e-5)
    else:
        ref = readings["float32"][0]
        assert np.abs(got - ref).max() <= 1.5 * np.abs(want - ref).max(), (got, want, ref)
    if detach_bug:
        assert not total.requires_grad
        return
    total.backward()
    if dtype == "float32":
        assert _rel(srt.grad.numpy(), want_grad) <= 1e-5
    else:
        ref_grad = readings["float32"][1]
        assert _rel(srt.grad.numpy(), ref_grad) <= 1.5 * _rel(want_grad, ref_grad)


def test_vgg19_npz_weights_load_as_in_jax(jax_vgg, tmp_path, monkeypatch):
    """``$SRGANFD_VGG19_NPZ`` (torchvision keys, OIHW) is read by both
    packages into the same network."""
    nodes = ("features.2", "features.7")
    sd = vgg19_flax_to_state_dict(jax_vgg.variables["params"])
    rng = np.random.default_rng(14)
    npz = {k: (v + 0.01 * rng.normal(size=v.shape)).astype(np.float32) for k, v in sd.items()
           if int(k.split(".")[1]) <= 7}
    path = tmp_path / "vgg19.npz"
    np.savez(path, **npz)
    monkeypatch.setenv("SRGANFD_VGG19_NPZ", str(path))
    got_params, pretrained = load_vgg19_params(nodes)
    assert pretrained and sorted(got_params) == sorted(npz)
    want_vars, want_pretrained = jax_load_vgg19_params(nodes)
    assert want_pretrained
    for k, v in vgg19_flax_to_state_dict(want_vars["params"]).items():
        np.testing.assert_array_equal(got_params[k].numpy(), v)
    assert not load_vgg19_params(nodes, npz_path=str(tmp_path / "absent.npz"))[1]


# -- LPIPS ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_lpips():
    return JaxLpips()


def test_lpips_linear_heads_are_the_jax_ones_bit_for_bit(jax_lpips):
    _, lins, pretrained = load_lpips_params()
    assert not pretrained and not jax_lpips.pretrained
    assert len(lins) == len(jax_lpips.lins) == 5
    for got, want in zip(lins, jax_lpips.lins):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_lpips_npz_weights_load(jax_lpips, tmp_path, monkeypatch):
    """``$SRGANFD_LPIPS_NPZ`` (the package's keys: ``alex.{i}`` OIHW,
    ``lin.{i}.weight`` (1, C, 1, 1)) replaces the surrogate."""
    rng = np.random.default_rng(16)
    sd = alexnet_flax_to_state_dict(jax_lpips.variables["params"])
    lins = {f"lin.{i}.weight": rng.uniform(size=(1, c, 1, 1)).astype(np.float32)
            for i, c in enumerate((64, 192, 384, 256, 256))}
    path = tmp_path / "lpips.npz"
    np.savez(path, **sd, **lins)
    monkeypatch.setenv("SRGANFD_LPIPS_NPZ", str(path))
    got_sd, got_lins, pretrained = load_lpips_params()
    assert pretrained and Lpips().pretrained
    for k, v in sd.items():
        np.testing.assert_array_equal(got_sd[k].numpy(), v)
    for i, lin in enumerate(got_lins):
        np.testing.assert_array_equal(lin, lins[f"lin.{i}.weight"].reshape(-1))


@pytest.mark.parametrize("lo", [0.0, -1.0], ids=["unit_range", "signed_range"])
def test_lpips_matches_jax(jax_lpips, lo):
    rng = np.random.default_rng(15)
    a = rng.uniform(lo, 1.0, size=(3, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=a.shape), lo, 1.0).astype(np.float32)
    want = np.asarray(jax.jit(jax_lpips.__call__)(jnp.asarray(a), jnp.asarray(b)))
    lpips = Lpips()  # the surrogate's linear heads are the JAX ones (the test above)
    lpips.module.load_state_dict(
        {k: _t(v) for k, v in alexnet_flax_to_state_dict(jax_lpips.variables["params"]).items()})
    got = lpips(_t(a), _t(b))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(lpips(_t(a), _t(a)).numpy(), 0.0, atol=1e-12)

