"""The self-attention U-Net discriminator (``discriminator_unet_sa``) of the
port against the JAX package's on the CPU: ``TokenSelfAttention`` and
``DiscriminatorUNetSA`` in f32 and f64 (the logit map, the up1 attention
map, ``u`` after ``update_stats``, full and chunked attention), the
gradients of a BCE on the logits against ``jax.grad``, the weight bridge,
every attention-bearing D in eval mode (``train=False``) on non-trivial
running statistics against the JAX module's default apply, and one tiny
``cli.train --config bsrgan --d-arch discriminator_unet_sa`` run that
``cli.test`` then evaluates.

Parameters are filled from numpy seeds (kernels N(0, 1/fan_in), biases
N(0, 0.1), ``u`` N(0, 1)), cast to each dtype, and handed to both
frameworks. Tiny widths: D 8 channels (attentions of 32 and 64 channels,
8 heads of 4 and 8) on 32 x 32 inputs.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu.models import create_model as create_flax
from srganfd_tpu.models.blocks import TokenSelfAttention as FlaxTokenSelfAttention
from srganfd_tpu_torch.cli import test as cli_test
from srganfd_tpu_torch.cli import train as cli_train
from srganfd_tpu_torch.convert import (
    attention_discriminator_flax_to_state_dict,
    discriminator_flax_to_state_dict,
    multiscale_attention_discriminator_flax_to_state_dict,
    sa_discriminator_flax_to_state_dict,
    token_attention_to_state_dict,
)
from srganfd_tpu_torch.models import create_model
from srganfd_tpu_torch.models.blocks import TokenSelfAttention
from srganfd_tpu_torch.train import checkpoint as ckpt
from srganfd_tpu_torch.track import tracker
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TINY_D = {"channels": 8}
SIZE = 32
DTYPES = {"float32": (jnp.float32, torch.float32), "float64": (jnp.float64, torch.float64)}
# f32: the two frameworks sum in other orders (outputs 1e-5 of the largest
# value, parameter gradients 1e-4 per tensor, as for the other Ds); f64:
# the same arithmetic to roundoff
TOL = {"float32": (1e-5, 1e-4), "float64": (1e-10, 1e-9)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _fill(shapes, seed, dtype=np.float32):
    """Every collection of an ``eval_shape``d init, filled from a seed:
    kernels N(0, 1/fan_in) (DenseGeneral's ``out`` contracts H x D),
    biases N(0, 0.1), BatchNorm scales 1 + N(0, 0.1), ``u`` N(0, 1), running
    means N(0, 0.2^2) and variances U(0.5, 2)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, parent = str(path[-1].key), str(path[-2].key) if len(path) > 1 else ""
        shape = leaf.shape
        if name == "kernel":
            fan_in = shape[0] if len(shape) == 3 and parent != "out" else int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, shape)
        elif name == "mean":
            v = 0.2 * rng.standard_normal(shape)
        elif name == "u":
            v = rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        return v.astype(dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _sa_variables(dtype=np.float32, **kw):
    model = create_flax("discriminator_unet_sa", **TINY_D, **kw)
    return _fill(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))), 5, dtype)


def _sa_port(variables, tdtype, **kw):
    port = create_model("discriminator_unet_sa", dtype=tdtype, **TINY_D, **kw).to(tdtype)
    port.load_state_dict({k: _t(v) for k, v in sa_discriminator_flax_to_state_dict(
        variables["params"], variables["spectral"]).items()})
    return port


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    return rng.uniform(size=(2, SIZE, SIZE, 3)), rng.uniform(size=(2, SIZE, SIZE, 1)) < 0.5


@pytest.mark.parametrize("chunk", [0, 7], ids=["full", "chunked"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_token_self_attention_matches_jax(dtype, chunk):
    """The output and the head-averaged map (None when chunked, as in JAX)
    on a 6 x 5 map of 16 channels, 8 heads of 2; logits divided by sqrt(D)
    after the product, as the JAX module computes them. The chunked
    attention computes in f32 in both packages, so it is held to the f32
    tolerance at either dtype."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 5, 16)).astype(np.dtype(jdt))
    flax_mod = FlaxTokenSelfAttention(16, dtype=jdt, chunk_size=chunk)
    params = _fill(jax.eval_shape(flax_mod.init, jax.random.PRNGKey(0), jnp.zeros((1, 6, 5, 16))), 6,
                   np.dtype(jdt))["params"]
    want, want_map = flax_mod.apply({"params": params}, jnp.asarray(x))
    port = TokenSelfAttention(16, chunk_size=chunk, attn_backend="chunked").to(tdt)
    port.load_state_dict({k: _t(v) for k, v in token_attention_to_state_dict(params).items()})
    got, got_map = port(_t(x).permute(0, 3, 1, 2))
    assert got.dtype == tdt
    assert _rel(got.permute(0, 2, 3, 1).detach().numpy(), want) <= TOL["float32" if chunk else dtype][0]
    if chunk:
        assert got_map is None and want_map is None
    else:
        assert got_map.shape == (2, 30, 30)
        assert _rel(got_map.detach().numpy(), want_map) <= TOL[dtype][0]


@pytest.fixture(scope="module")
def jax_sa(inputs):
    """Per dtype: the filled variables, and the JAX D's train-mode forward
    with the gradients of a BCE on its logits (random 0/1 labels) with
    respect to the input and every parameter, and the ``u`` it writes."""
    x, labels = inputs
    out = {}
    for dtype, (jdt, _) in DTYPES.items():
        variables = _sa_variables(np.dtype(jdt))
        model = create_flax("discriminator_unet_sa", dtype=jdt, **TINY_D)

        def loss(p, xx, model=model, variables=variables):
            (logits, amap), new = model.apply({"params": p, "spectral": variables["spectral"]}, xx, train=True,
                                              mutable=["spectral"])
            z = logits.astype(jnp.float64)
            bce = jnp.mean(jnp.maximum(z, 0) - z * labels + jnp.log1p(jnp.exp(-jnp.abs(z))))
            return bce, (logits, amap, new["spectral"])

        (_, (logits, amap, u)), (g_p, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            variables["params"], jnp.asarray(x, jdt))
        out[dtype] = (variables, {"logits": np.asarray(logits), "map": np.asarray(amap), "x": np.asarray(g_x),
                                  "grads": sa_discriminator_flax_to_state_dict(g_p, u), "u": u})
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sa_discriminator_matches_jax(jax_sa, inputs, dtype):
    """A train-mode forward with ``update_stats``: the logit map, the up1
    attention map (N, 64, 64) and each written ``u``; then the gradients
    of the BCE with respect to the input and every parameter, against
    ``jax.grad`` (``TOL``; ``u`` to 1e-6, the power iteration)."""
    _, tdt = DTYPES[dtype]
    variables, want = jax_sa[dtype]
    x, labels = inputs
    port = _sa_port(variables, tdt)
    xt = _t(x).to(tdt).requires_grad_()
    logits, amap = port(xt, update_stats=True, train=True)
    assert logits.dtype == tdt and logits.shape == (2, SIZE, SIZE, 1) and amap.shape == (2, 64, 64)
    torch.nn.functional.binary_cross_entropy_with_logits(logits.double(), _t(labels).double()).backward()
    out_tol, grad_tol = TOL[dtype]
    assert _rel(logits.detach().numpy(), want["logits"]) <= out_tol
    assert _rel(amap.detach().numpy(), want["map"]) <= out_tol
    assert _rel(xt.grad.numpy(), want["x"]) <= out_tol * 10
    state = port.state_dict()
    got = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert set(got) | {k for k in state if k.endswith(".u")} == set(want["grads"])
    for k, w in want["grads"].items():
        if k.endswith(".u"):
            np.testing.assert_allclose(state[k].numpy(), w, rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            assert _rel(got[k], w) <= grad_tol, (k, _rel(got[k], w))


def test_chunked_sa_discriminator_drops_the_map_and_keeps_the_logits(jax_sa, inputs):
    """``attn_chunk`` > 0: the attentions run in query chunks (the chunked
    backend), the map is None as in JAX, and the logits are JAX's chunked
    ones (f32, 1e-5) and the full ones'. The flash backend refuses it under
    grad, naming B4 and the head dims."""
    variables, want = jax_sa["float32"]
    x, _ = inputs
    flax_chunked = create_flax("discriminator_unet_sa", attn_chunk=24, **TINY_D)
    want_c, want_map = jax.jit(flax_chunked.apply)(variables, jnp.asarray(x, jnp.float32))
    port = _sa_port(variables, torch.float32, attn_chunk=24, attn_backend="chunked")
    logits, amap = port(_t(x).float())
    assert amap is None and want_map is None
    assert _rel(logits.detach().numpy(), want_c) <= 1e-5
    assert _rel(logits.detach().numpy(), want["logits"]) <= 1e-5  # the full attention's, in train mode
    flash = _sa_port(variables, torch.float32, attn_chunk=24, attn_backend="flash")
    with pytest.raises(NotImplementedError, match=r"B4.*head dims \(16, 32\), this layer's is 4"):
        flash(_t(x).float().requires_grad_())


def test_sa_bridge_refuses_other_trees():
    """The bridge takes the SA D's tree only: a missing attention, an extra
    leaf in one, or an extra conv raises."""
    variables = _sa_variables()
    params, spectral = dict(variables["params"]), variables["spectral"]
    missing = {k: v for k, v in params.items() if k != "TokenSelfAttention_2"}
    with pytest.raises(ValueError, match="TokenSelfAttention_0..2"):
        sa_discriminator_flax_to_state_dict(missing, spectral)
    extra_leaf = {**params, "TokenSelfAttention_1": {**params["TokenSelfAttention_1"], "gate": {"bias": np.zeros(2)}}}
    with pytest.raises(ValueError, match="TokenSelfAttention subtree"):
        sa_discriminator_flax_to_state_dict(extra_leaf, spectral)
    with pytest.raises(ValueError, match="discriminator_unet"):
        sa_discriminator_flax_to_state_dict({**params, "Conv_2": params["Conv_1"]}, spectral)


EVAL_ARCHS = {  # arch: (tiny kwargs, its bridge from the Flax variables)
    "discriminator_unet": (TINY_D, lambda v: discriminator_flax_to_state_dict(v["params"], v["spectral"])),
    "discriminator_unet_sa": (TINY_D, lambda v: sa_discriminator_flax_to_state_dict(v["params"], v["spectral"])),
    "uNetDiscriminatorAesrgan": ({"num_feat": 8}, lambda v: attention_discriminator_flax_to_state_dict(
        v["params"], v["batch_stats"], v["spectral"])),
    "discriminator_attention_unet_ms": ({"num_feat": 8}, lambda v: multiscale_attention_discriminator_flax_to_state_dict(
        v["params"], v["batch_stats"], v["spectral"])),
}


@pytest.mark.parametrize("arch", list(EVAL_ARCHS))
def test_discriminators_in_eval_mode_match_jax_default_apply(arch, inputs):
    """``train=False`` (each D's default, as in JAX) against the JAX
    module's default apply, on random running statistics: the BatchNorm
    gates normalise with them, nothing is written; every logit map and
    attention map to 1e-5 (f32). The attention U-Net's train mode on the
    same input differs from it."""
    kw, bridge = EVAL_ARCHS[arch]
    model = create_flax(arch, **kw)
    variables = _fill(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))), 8)
    x = jnp.asarray(inputs[0], jnp.float32)
    want = jax.jit(model.apply)(variables, x)
    port = create_model(arch, **kw)
    port.load_state_dict({k: _t(v) for k, v in bridge(variables).items()})
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got = port(_t(inputs[0]).float())
    pairs = list(zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.detach().numpy(), got, is_leaf=lambda t: isinstance(t, torch.Tensor)))))
    assert pairs and len(jax.tree_util.tree_leaves(want)) == len(pairs)
    for w, g in pairs:
        assert g.shape == w.shape and _rel(g, w) <= 1e-5
    assert all(torch.equal(before[k], v) for k, v in port.state_dict().items())
    if "batch_stats" in variables:
        train_out = port(_t(inputs[0]).float(), train=True)
        first = lambda o: o[0][0] if isinstance(o[0], tuple) else o[0]  # noqa: E731
        assert _rel(first(train_out).detach().numpy(), first(want)) > 1e-3


@pytest.fixture(autouse=True)
def _jsonl_only(monkeypatch):
    monkeypatch.setattr(tracker, "_optional_summary_writer", lambda: None)


def test_cli_train_sa_then_cli_test(tmp_path, monkeypatch):
    """``cli.train --config bsrgan --d-arch discriminator_unet_sa --tiny``
    (two steps at GT 32, the D at its width, 64), then ``cli.test`` on its
    ``ckpt_last.pth`` with the same ``--d-arch``: the checkpoint holds the
    SA D with its attentions and advanced ``u``; the evaluation writes the
    D(gt)/D(sr) heat-maps and the up1 attention map of each frame, and
    finite metrics."""
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(3)
    for i in range(4):
        cv2.imwrite(str(frames / f"f{i}.png"), (rng.uniform(size=(48, 48, 3)) * 255).astype(np.uint8))
    monkeypatch.chdir(tmp_path)
    cli_train.main(["--config", "bsrgan", "--d-arch", "discriminator_unet_sa", "--tiny", "--gt-size", "32",
                    "--batch-size", "2", "--steps-per-epoch", "2", "--epochs", "1", "--device-type", "cpu",
                    "--train-dir", str(frames), "--valid-dir", str(frames)])
    path = tmp_path / "results" / "BSRGAN_x2" / "ckpt_last.pth"
    payload = ckpt.load_checkpoint(str(path))
    d = payload["d_state_dict"]
    assert payload["step"] == 2 and {"attn_down2.in_proj_weight", "attn_up1.out_proj.bias", "conv4.u"} <= set(d)
    init = create_model("discriminator_unet_sa", generator=torch.Generator().manual_seed(0)).state_dict()
    assert not torch.equal(d["conv4.u"], init["conv4.u"]) or not torch.equal(d["conv1.weight"], init["conv1.weight"])
    cli_test.main(["--config", "bsrgan", "--d-arch", "discriminator_unet_sa", "--tiny", "--gt-dir", str(frames),
                   "--weights", str(path), "--max-images", "2", "--save-discriminator-eval",
                   "--save-attention-layers", "--device-type", "cpu"])
    logs = tmp_path / "samples" / "logs" / "BSRGANsa_x2_bubbles"
    names = sorted(os.listdir(logs))
    assert {"d_gt_0000.png", "d_sr_0001.png", "attn0_0000.png", "attn0_0001.png", "test_metrics.json"} <= set(names)
    assert cv2.imread(str(logs / "attn0_0000.png")).shape == (16, 16, 3)  # 64 x 64 bucket: 16 x 16 up1 tokens
