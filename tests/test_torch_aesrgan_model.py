"""The port's A-ESRGAN modules against the JAX package's on the CPU: Flax's
``BatchNorm`` in training mode, the attention-gated U-Net discriminator
(``uNetDiscriminatorAesrgan``) and its multi-scale ensemble
(``discriminator_attention_unet_ms``) with their weight bridges, and the
gradients of ``bsrgantrans_x2`` through its transformer bottleneck.

Inputs are made with numpy from a seed and handed to both frameworks;
weights are the JAX modules' init, converted. The Flax variables are cast
to f32 before use: with x64 on (as these tests run JAX), Flax draws the
spectral-norm ``u`` in f64 and would iterate in f64, where the port keeps
``u`` in f32. Tiny widths: D 8 features on 32 x 32 (sides of 16k, so the
ensemble's second scale meets the U-Net's multiple of 8); G 16 channels,
growth 8, 2 RRDBs, 4 heads of 4.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu.models import create_model as create_flax
from srganfd_tpu_torch.convert import (
    attention_discriminator_flax_to_state_dict,
    flax_to_state_dict,
    multiscale_attention_discriminator_flax_to_state_dict,
)
from srganfd_tpu_torch.models import create_model
from srganfd_tpu_torch.models.blocks import BatchNorm
from test_torch_bsrgantrans import TINY as TINY_TRANS
from test_torch_bsrgantrans import trans_params
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

ARCHS = {
    "single": ("uNetDiscriminatorAesrgan", attention_discriminator_flax_to_state_dict),
    "ensemble": ("discriminator_attention_unet_ms", multiscale_attention_discriminator_flax_to_state_dict),
}
TINY_D = {"num_feat": 8}
SIZE = 32
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _logit_maps(out):
    """The logit maps of either D's output, as a tuple."""
    return out[0] if isinstance(out[0], tuple) else (out[0],)


def _state_dict(which, variables):
    return {k: _t(v) for k, v in ARCHS[which][1](variables["params"], variables["batch_stats"],
                                                  variables["spectral"]).items()}


@functools.cache
def flax_d(which):
    """The tiny Flax D's f32 variables, one input and one cotangent per
    logit map, and per dtype the train-mode forward (logit maps, attention
    maps, the new ``batch_stats`` and ``spectral``); in f32 also the
    gradients of the cotangents' projection with respect to the input and
    every parameter, through ``jax.value_and_grad``."""
    arch = ARCHS[which][0]
    model = create_flax(arch, **TINY_D)
    variables = jax.jit(model.init)(jax.random.PRNGKey(4), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    variables = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), variables)
    rng = np.random.default_rng(21)
    x = rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    n_maps = 2 if which == "ensemble" else 1
    cots = [rng.normal(size=(2, SIZE >> s, SIZE >> s, 1)).astype(np.float32) for s in range(n_maps)]
    results = {}
    for dtype, (jdt, _) in DTYPES.items():
        m = create_flax(arch, dtype=jdt, **TINY_D)

        def loss(p, xx, m=m):
            out, new = m.apply({**variables, "params": p}, xx, train=True, mutable=["batch_stats", "spectral"])
            proj = sum(jnp.sum(o.astype(jnp.float32) * c) for o, c in zip(_logit_maps(out), cots))
            return proj, (out, new)

        if dtype == "float32":
            (_, (out, new)), (g_params, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
                variables["params"], jnp.asarray(x))
        else:  # the forward alone
            _, (out, new) = jax.jit(loss)(variables["params"], jnp.asarray(x))
        results[dtype] = {
            "logits": [np.asarray(o, np.float32) for o in _logit_maps(out)],
            "attention": [np.asarray(a, np.float32) for a in out[1]],
            "state": {k: v for k, v in ARCHS[which][1](variables["params"], new["batch_stats"], new["spectral"]).items()
                      if k.endswith((".u", ".running_mean", ".running_var"))},
        }
        if dtype == "float32":
            results[dtype]["grads"] = {"x": np.asarray(g_x), **{k: v for k, v in ARCHS[which][1](
                g_params, variables["batch_stats"], variables["spectral"]).items()
                if not k.endswith((".u", ".running_mean", ".running_var"))}}
    return variables, x, cots, results


def _port(which, dtype=torch.float32):
    variables = flax_d(which)[0]
    port = create_model(ARCHS[which][0], dtype=dtype, **TINY_D)
    port.load_state_dict(_state_dict(which, variables))
    return port


def _run(which, dtype, update_stats=True):
    """The port's forward and the same projection's backward; returns its
    output, the input's gradient and the port."""
    _, x, cots, _ = flax_d(which)
    port = _port(which, DTYPES[dtype][1])
    xt = _t(x).requires_grad_()
    out = port(xt, update_stats=update_stats, train=True)
    sum((o * _t(c)).sum() for o, c in zip(_logit_maps(out), cots)).backward()
    return out, xt.grad, port


# -- BatchNorm ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_flax_in_training_mode(dtype):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, param_dtype=f32)``
    with ``use_running_average=False``: the output, the running statistics
    it writes (the biased fast variance), and the gradients with respect
    to the input, scale and bias through the batch statistics. f32: 1e-5
    of the largest value, running statistics 1e-6. bf16: statistics in f32
    in both (to 1e-6), the output within one bf16 ulp of its magnitude."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = (2.0 + 3.0 * rng.normal(size=(4, 5, 6, 7))).astype(np.float32)  # NHWC, a mean far from 0
    cot = rng.normal(size=x.shape).astype(np.float32)
    scale, bias = (1 + 0.1 * rng.normal(size=7)).astype(np.float32), (0.1 * rng.normal(size=7)).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdt, param_dtype=jnp.float32)
    stats = {"mean": 0.1 * rng.normal(size=7).astype(np.float32), "var": (1 + rng.uniform(size=7)).astype(np.float32)}

    def loss(p, xx):
        out, new = bn.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * cot), (out, new["batch_stats"])

    (_, (want, new)), (g_p, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        {"scale": scale, "bias": bias}, jnp.asarray(x, jdt))

    port = BatchNorm(7)
    port.load_state_dict({"weight": _t(scale), "bias": _t(bias), "running_mean": _t(stats["mean"]),
                          "running_var": _t(stats["var"])})
    xt = _t(x).to(tdt).permute(0, 3, 1, 2).detach().requires_grad_()
    got = port(xt, update_stats=True)
    assert got.dtype == tdt
    (got.float().permute(0, 2, 3, 1) * _t(cot)).sum().backward()
    np.testing.assert_allclose(port.running_mean.numpy(), new["mean"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), new["var"], rtol=1e-6, atol=1e-6)
    got = got.detach().float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        assert _rel(got, want) <= 1e-5
        assert _rel(xt.grad.permute(0, 2, 3, 1).numpy(), g_x) <= 1e-5
        for name, jname in (("weight", "scale"), ("bias", "bias")):
            assert _rel(getattr(port, name).grad.numpy(), g_p[jname]) <= 1e-5, name
    else:
        assert np.abs(got - want).max() <= 2.0**-8 * np.abs(want).max()


def test_batchnorm_without_update_stats_writes_nothing_and_differs_from_torch_batchnorm():
    """``update_stats=False`` normalises with the batch's statistics, passes
    the gradient through them, and writes nothing; ``nn.BatchNorm2d`` in
    training mode writes the unbiased variance, n/(n-1) times the biased
    one that Flax (and the port) keeps."""
    rng = np.random.default_rng(5)
    x = _t((1.0 + rng.normal(size=(2, 3, 4, 5))).astype(np.float32))
    port, torch_bn = BatchNorm(3), torch.nn.BatchNorm2d(3, momentum=0.1)
    xg = x.clone().requires_grad_()
    y = port(xg, update_stats=False)
    assert torch.equal(port.running_mean, torch.zeros(3)) and torch.equal(port.running_var, torch.ones(3))
    (y * y[:, :, :1, :1]).sum().backward()  # a projection whose gradient sees the statistics
    assert xg.grad.abs().max() > 0
    torch.testing.assert_close(y, torch_bn(x), rtol=1e-5, atol=1e-5)  # the same normalisation
    port(x, update_stats=True)
    n = x.numel() // 3
    torch.testing.assert_close(torch_bn.running_var - 0.9, (port.running_var - 0.9) * n / (n - 1))


# -- the attention U-Net discriminators ------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ARCHS)
def test_attention_discriminator_forward_matches_flax(which, dtype):
    """A train-mode forward against the Flax module's: every logit map and
    the three attention maps (scale 0's for the ensemble), NHWC. f32: 1e-5
    of the largest value. bf16: the two frameworks round different sums,
    so each is held to the JAX f32 result, the port no further from it
    than 1.5x the JAX bf16 result is (and within 2**-6 of the largest
    value)."""
    results = flax_d(which)[3]
    out, _, _ = _run(which, dtype)
    logits, attention = _logit_maps(out), out[1]
    assert all(o.dtype == torch.float32 for o in logits) and len(attention) == 3
    assert [tuple(o.shape) for o in logits] == [r.shape for r in results[dtype]["logits"]]
    assert [tuple(a.shape) for a in attention] == [(2, SIZE >> s, SIZE >> s, 1) for s in (2, 1, 0)]
    pairs = [(f"logits {i}", o, i, "logits") for i, o in enumerate(logits)]
    pairs += [(f"ly{i + 1}", a, i, "attention") for i, a in enumerate(attention)]
    for name, got, i, key in pairs:
        got = got.detach().float().numpy()
        if dtype == "float32":
            assert _rel(got, results["float32"][key][i]) <= 1e-5, name
        else:
            ref, jax_bf16 = results["float32"][key][i], results["bfloat16"][key][i]
            assert _rel(got, ref) <= max(1.5 * _rel(jax_bf16, ref), 2.0**-6), (name, _rel(got, ref),
                                                                                  _rel(jax_bf16, ref))


@pytest.mark.parametrize("update_stats", [True, False], ids=["update", "no_update"])
@pytest.mark.parametrize("which", ARCHS)
def test_attention_discriminator_state_matches_flax(which, update_stats):
    """The gates' running statistics (to 1e-6) and every ``u`` (to 1e-5
    relative) that a train-mode forward writes with ``update_stats``, as
    the Flax module writes its ``batch_stats`` and ``spectral``; without
    it the port writes neither."""
    _, _, port = _run(which, "float32", update_stats)
    got = port.state_dict()
    before = _state_dict(which, flax_d(which)[0])
    want = flax_d(which)[3]["float32"]["state"]
    assert sum(k.endswith(".running_var") for k in want) == 3 * (2 if which == "ensemble" else 1)
    for k, w in want.items():
        if not update_stats:
            assert torch.equal(got[k], before[k]), k
        elif k.endswith(".u"):
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5, atol=1e-6, err_msg=k)
    if update_stats:
        assert any(not torch.equal(got[k], before[k]) for k in want if "running" in k)


@pytest.mark.parametrize("which", ARCHS)
def test_attention_discriminator_gradients_match_jax(which):
    """f32 gradients of the logit maps' projection with respect to the
    input and every parameter, against ``jax.grad`` through the Flax
    module: the input's to 1e-5 of its largest, the parameters' per tensor
    to 1e-4 (sums of more terms; the batch statistics' backward among
    them). Two kinds of tensor differ: the bias of the 1x1 conv before
    each gate's BatchNorm has no gradient (the batch mean takes it out),
    and both frameworks leave roundoff there (JAX up to 7.8e-6 of the
    BatchNorm bias's gradient, the sum that cancels), held below 2e-5 of
    it; each gate's ``psi`` bias, one scalar whose
    gradient sums every pixel's gate cotangent with cancellation, reads up
    to 9e-5 off the f64 gradient in either framework (measured), so it is
    held to 5e-4."""
    _, x_grad, port = _run(which, "float32")
    want = flax_d(which)[3]["float32"]["grads"]
    got = {"x": x_grad.numpy(), **{k: p.grad.numpy() for k, p in port.named_parameters()}}
    assert set(got) == set(want)
    for name, w in want.items():
        if name.endswith("W.0.bias"):
            scale = np.abs(want[name.replace("W.0.bias", "W.1.bias")]).max()
            assert max(np.abs(got[name]).max(), np.abs(w).max()) <= 2e-5 * scale, name
        else:
            tol = 1e-5 if name == "x" else 5e-4 if name.endswith("psi.bias") else 1e-4
            assert _rel(got[name], w) <= tol, (name, _rel(got[name], w))


def test_ensemble_scales_need_sides_of_16k_as_in_jax():
    """At the ``aesrgan`` config's GT 120 the ensemble's second scale (60)
    takes an odd side (15) to a stride-2 stage: the JAX module fails to
    concatenate its skip (15) with the upsampled map (16), and the port
    raises naming the rule. The single-scale D takes 120."""
    with pytest.raises(TypeError, match="concatenate"):
        jax.eval_shape(create_flax("discriminator_attention_unet_ms", **TINY_D).init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 120, 120, 3)))
    port = create_model("discriminator_attention_unet_ms", **TINY_D)
    with pytest.raises(ValueError, match="multiples of 8"):
        port(torch.zeros(1, 120, 120, 3))
    out, attention = create_model("uNetDiscriminatorAesrgan", **TINY_D)(torch.zeros(1, 120, 120, 3))
    assert out.shape == (1, 120, 120, 1) and attention[0].shape == (1, 30, 30, 1)


@pytest.mark.parametrize("where", ["params", "batch_stats", "spectral", "scale"])
def test_attention_bridge_refuses_a_tree_with_an_extra_leaf(where):
    """A leaf the mapping would not place raises instead of being dropped:
    in the params, the running statistics, the ``u`` vectors, or a third
    scale the ensemble does not have."""
    variables = flax_d("single")[0]
    trees = {k: jax.tree_util.tree_map(np.asarray, dict(variables[k])) for k in ("params", "batch_stats", "spectral")}
    if where == "scale":
        ens = flax_d("ensemble")[0]
        trees = {k: {**jax.tree_util.tree_map(np.asarray, dict(ens[k])), "D9": trees[k]} for k in trees}
        with pytest.raises(ValueError, match="D0"):
            multiscale_attention_discriminator_flax_to_state_dict(*trees.values())
        return
    extra = {"params": ("_AddAttn_0", "Conv_9"), "batch_stats": ("_AddAttn_1", "BatchNorm_1"),
             "spectral": ("SNConv_9", None)}[where]
    tree = trees[where]
    tree[extra[0]] = dict(tree.get(extra[0], {}))
    if extra[1] is None:
        tree[extra[0]]["u"] = np.zeros(4, np.float32)
    else:
        tree[extra[0]][extra[1]] = {"kernel": np.zeros((1, 1, 8, 8), np.float32)}
    with pytest.raises(ValueError, match="attention U-Net discriminator"):
        attention_discriminator_flax_to_state_dict(trees["params"], trees["batch_stats"], trees["spectral"])


# -- bsrgantrans_x2's gradients ---------------------------------------------------------


def test_bsrgantrans_parameter_gradients_match_jax():
    """The generator the ``aesrgan`` config trains, differentiated through
    its transformer bottleneck (full softmax attention,
    ``dot_product_attention``, under autograd) and its RDBs (``rdb_apply``):
    every parameter's gradient of a random projection of the output, f32,
    against ``jax.grad`` through the JAX module, to 1e-4 of each tensor's
    largest (f32 sums of up to ~10^4 terms in both frameworks, in other
    orders)."""
    params = trans_params()
    rng = np.random.default_rng(31)
    x = rng.uniform(size=(2, 12, 16, 3)).astype(np.float32)
    cot = rng.normal(size=(2, 24, 32, 3)).astype(np.float32)
    model = create_flax("bsrgantrans_x2", **TINY_TRANS)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(model.apply({"params": p}, jnp.asarray(x)) * cot)))(params)
    want = flax_to_state_dict(grads)

    port = create_model("bsrgantrans_x2", **TINY_TRANS)
    port.load_state_dict({k: _t(v) for k, v in flax_to_state_dict(params).items()})
    (port(_t(x)) * _t(cot)).sum().backward()
    got = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert set(got) == set(want) and any(k.startswith("transformer.") for k in got)
    for name, w in want.items():
        assert _rel(got[name], w) <= 1e-4, (name, _rel(got[name], w))
