"""The port's generators against the JAX package's on the same converted
weights and the same numpy inputs (tiny widths: 16 channels, growth 8,
2 RRDBs)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu.models import create_model as create_flax
from srganfd_tpu.ops.pallas import rdb as pallas_rdb
from srganfd_tpu_torch.convert import flax_to_state_dict
from srganfd_tpu_torch.models import create_model

ARCHS = ["bsrgan_x2", "bsrgan_x4", "rrdbnet_x4"]


def tiny_kwargs(arch):
    depth = "num_rrdb" if arch.startswith("bsrgan") else "num_blocks"
    return {"channels": 16, "growth_channels": 8, depth: 2}


@functools.cache
def tiny_params(arch):
    """The tiny JAX model's param tree, its structure from ``eval_shape``
    (no eager init runs), filled from a numpy seed: kernels N(0, 1/fan_in),
    biases N(0, 0.1), and 0.5 more on the last conv's bias, so that the
    outputs spread over [0, 1] instead of clamping (the model's own
    kaiming x0.1 init gives outputs near 0)."""
    model = create_flax(arch, **tiny_kwargs(arch))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3), jnp.float32))
    rng = np.random.default_rng(0)

    def draw(s):
        if len(s.shape) == 4:  # HWIO kernel
            fan_in = s.shape[0] * s.shape[1] * s.shape[2]
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    params = jax.tree_util.tree_map(draw, dict(shapes["params"]))
    last = max((k for k in params if k.startswith("Conv_")), key=lambda k: int(k[5:]))
    params[last]["Conv_0"]["bias"] += 0.5
    return params


def _jax(arch, x, **kw):
    model = create_flax(arch, **tiny_kwargs(arch), **kw)
    return np.asarray(jax.jit(model.apply)({"params": tiny_params(arch)}, jnp.asarray(x)))


def _port(arch, dtype):
    model = create_model(arch, dtype=dtype, **tiny_kwargs(arch))
    sd = flax_to_state_dict(tiny_params(arch))
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return model.eval()


def _lr(seed, shape=(2, 12, 10, 3)):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _run_port(model, x):
    with torch.inference_mode():
        y = model(torch.from_numpy(x))
    assert y.dtype == torch.float32
    return y.numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_generator_matches_jax_f32(arch):
    x = _lr(0)
    want = _jax(arch, x)
    got = _run_port(_port(arch, torch.float32), x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_generator_matches_jax_bf16_pallas(arch, monkeypatch):
    """bf16 against the JAX model with ``pallas=1`` (the RDB kernel run in
    interpret mode). The trunk rounds at the same points; the non-trunk
    convs do not (XLA adds the bias to the bf16 conv output in bf16,
    oneDNN before the output is rounded), so the tolerance is 4 bf16 ulps
    at 1.0 (2**-6)."""
    monkeypatch.setattr(
        pallas_rdb, "rdb_forward_pallas",
        functools.partial(pallas_rdb.rdb_forward_pallas, interpret=True),
    )
    x = _lr(1)
    want = _jax(arch, x, dtype=jnp.bfloat16, pallas=1)
    got = _run_port(_port(arch, torch.bfloat16), x)
    assert want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2**-6, rtol=0)
