"""The port's RDB against the JAX package's.

``rdb_forward_ref`` (the plain version the CUDA kernel is held to on the
card) must compute what the Pallas kernels compute: both entry points run
here in interpret mode, as ``tests/test_pallas_kernels.py`` runs them, and
the Flax ``ResidualDenseBlock`` is the f32 reference. Inputs are made with
numpy from a seed and handed to both frameworks as float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu.models.blocks import ResidualDenseBlock as FlaxRDB
from srganfd_tpu.ops.pallas.rdb import rdb_forward_pallas, rdb_forward_pallas_v2
from srganfd_tpu_torch.models.blocks import ResidualDenseBlock
from srganfd_tpu_torch.ops.cuda import rdb as rdb_mod

CH, GC = 16, 8


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    kernels, biases = [], []
    for k in range(5):
        cin, cout = CH + k * GC, GC if k < 4 else CH
        kernels.append((rng.normal(size=(3, 3, cin, cout)) * np.sqrt(2 / (9 * cin))).astype(np.float32))
        biases.append((rng.normal(size=(cout,)) * 0.1).astype(np.float32))
    return x, kernels, biases


def _port(x, kernels, biases, dtype):
    t = torch.from_numpy
    y = rdb_mod.rdb_forward_ref(t(x).to(dtype), [t(k) for k in kernels], [t(b) for b in biases])
    assert y.dtype == dtype and y.shape == x.shape
    return y.float().numpy()


def _pallas(entry, x, kernels, biases, dtype):
    xj = jnp.asarray(x, jnp.float32).astype(dtype)
    ks = [jnp.asarray(k, jnp.float32) for k in kernels]
    bs = [jnp.asarray(b, jnp.float32) for b in biases]
    if entry == "v1":
        y = rdb_forward_pallas(xj, ks, bs, tile_h=8, interpret=True)
    else:
        y = rdb_forward_pallas_v2(xj, ks, bs, batch_tile=2, interpret=True)
    return np.asarray(y.astype(jnp.float32))


def _flax(x, kernels, biases):
    params = {f"conv{k}_kernel": jnp.asarray(kernels[k]) for k in range(5)}
    params.update({f"conv{k}_bias": jnp.asarray(biases[k]) for k in range(5)})
    return np.asarray(FlaxRDB(CH, GC).apply({"params": params}, jnp.asarray(x, jnp.float32)))


@pytest.mark.parametrize("entry", ["v1", "v2"])
def test_rdb_ref_matches_pallas_f32(entry):
    x, ks, bs = _inputs((2, 16, 12, CH), seed=0)
    np.testing.assert_allclose(
        _port(x, ks, bs, torch.float32), _pallas(entry, x, ks, bs, jnp.float32),
        atol=3e-6, rtol=1e-5,
    )


@pytest.mark.parametrize("entry", ["v1", "v2"])
def test_rdb_ref_matches_pallas_bf16_exactly(entry):
    """Same rounding points (operands and out_k in bf16, f32 sums, residual
    in f32): the bf16 outputs are equal."""
    x, ks, bs = _inputs((2, 16, 12, CH), seed=1)
    np.testing.assert_array_equal(
        _port(x, ks, bs, torch.bfloat16), _pallas(entry, x, ks, bs, jnp.bfloat16)
    )


@pytest.mark.parametrize("shape", [(2, 16, 12, CH), (2, 48, 48, CH)])
def test_rdb_ref_matches_flax_block(shape):
    """(2, 48, 48) is where the JAX v2 kernel gives way to XLA
    (bt*H*W > 2048): the port's kernel takes any H x W."""
    x, ks, bs = _inputs(shape, seed=2)
    np.testing.assert_allclose(_port(x, ks, bs, torch.float32), _flax(x, ks, bs), atol=3e-6, rtol=1e-5)


def test_rdb_module_on_cpu_uses_plain_version():
    x, ks, bs = _inputs((1, 10, 14, CH), seed=3)
    block = ResidualDenseBlock(CH, GC)
    with torch.no_grad():
        for k in range(5):
            conv = getattr(block, f"conv{k + 1}")
            conv.weight.copy_(torch.from_numpy(ks[k]).permute(3, 2, 0, 1))
            conv.bias.copy_(torch.from_numpy(bs[k]))
    rdb_mod.launches = 0
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        got = block(xt).permute(0, 2, 3, 1).numpy()
        via_wrapper = rdb_mod.rdb_forward(torch.from_numpy(x), *block.kernels_biases()).numpy()
    np.testing.assert_array_equal(got, _port(x, ks, bs, torch.float32))
    np.testing.assert_array_equal(via_wrapper, got)
    assert rdb_mod.launches == 0  # the counter counts kernel calls only


def test_rdb_forward_refuses_other_devices():
    x, ks, bs = _inputs((1, 4, 4, CH), seed=4)
    t = torch.from_numpy
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        rdb_mod.rdb_forward(t(x).to("meta"), [t(k) for k in ks], [t(b) for b in bs])


def _leaves(x, kernels, biases, dtype=torch.float32):
    t = torch.from_numpy
    return [t(x).to(dtype).requires_grad_(), *[t(k).requires_grad_() for k in kernels],
            *[t(b).requires_grad_() for b in biases]]


def test_rdb_apply_gradients_match_jax():
    """d/d(x, kernels, biases) of sum(y * c), against ``jax.grad`` through
    the JAX ``rdb_apply`` (Pallas forward in interpret mode, XLA backward of
    the recomputed block)."""
    import functools

    import jax

    from srganfd_tpu.ops.pallas import rdb as jax_rdb

    x, ks, bs = _inputs((2, 16, 12, CH), seed=6)
    cot = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    leaves = _leaves(x, ks, bs)
    y = rdb_mod.rdb_apply(leaves[0], leaves[1:6], leaves[6:])
    got = torch.autograd.grad(y, leaves, torch.from_numpy(cot))

    orig = jax_rdb.rdb_forward_pallas
    jax_rdb.rdb_forward_pallas = functools.partial(orig, interpret=True)
    try:
        def loss(x_in, kernels, biases):
            return jnp.sum(jax_rdb.rdb_apply(x_in, kernels, biases, 8) * cot)

        want = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(x), tuple(map(jnp.asarray, ks)), tuple(map(jnp.asarray, bs)))
    finally:
        jax_rdb.rdb_forward_pallas = orig
    want = [want[0], *want[1], *want[2]]
    names = ["x"] + [f"kernel{k}" for k in range(5)] + [f"bias{k}" for k in range(5)]
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rdb_apply_backward_is_autograd_through_the_plain_version(dtype):
    """On the CPU the Function's backward (recompute, then pull the
    cotangent through) is plain autograd through ``rdb_forward_ref``,
    bit for bit, with the forward's rounding points in bf16 too."""
    x, ks, bs = _inputs((1, 9, 11, CH), seed=8)
    cot = torch.from_numpy(np.random.default_rng(9).normal(size=x.shape).astype(np.float32)).to(dtype)
    a, b = _leaves(x, ks, bs, dtype), _leaves(x, ks, bs, dtype)
    ya = rdb_mod.rdb_apply(a[0], a[1:6], a[6:])
    yb = rdb_mod.rdb_forward_ref(b[0], b[1:6], b[6:])
    assert torch.equal(ya, yb) and ya.dtype == dtype
    for ga, gb in zip(torch.autograd.grad(ya, a, cot), torch.autograd.grad(yb, b, cot)):
        assert torch.equal(ga, gb)


def test_rdb_forward_under_grad_goes_through_rdb_apply():
    """``rdb_forward`` with an input that needs a gradient is never cut from
    the graph: it routes through the Function."""
    x, ks, bs = _inputs((1, 6, 7, CH), seed=10)
    leaves = _leaves(x, ks, bs)
    y = rdb_mod.rdb_forward(leaves[0], leaves[1:6], leaves[6:])
    assert y.grad_fn is not None and "RdbApply" in type(y.grad_fn).__name__
    y.sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in leaves)


def test_block_trains_and_repacks_after_each_optimizer_step():
    """Gradients reach all ten parameters of a block, and an in-place Adam
    update (the multi-tensor form, as on the card) changes the key of the
    packed-weight cache, so the kernel never runs on stale weights."""
    block = ResidualDenseBlock(CH, GC)
    x = torch.randn(2, CH, 6, 5, generator=torch.Generator().manual_seed(11))
    x = x.contiguous(memory_format=torch.channels_last)
    block(x).square().mean().backward()
    params = list(block.parameters())
    assert len(params) == 10 and all(p.grad is not None and p.grad.abs().sum() > 0 for p in params)
    block.packed(torch.float32)
    key = block._packed[0]
    torch.optim.Adam(block.parameters(), lr=1e-3, foreach=True).step()
    block.packed(torch.float32)
    assert block._packed[0] != key


def test_pack_rdb_weights_layout():
    """The packed buffer is each HWIO kernel in [cin][3*3][cout] order, in
    x's dtype; biases stay f32."""
    _, ks, bs = _inputs((1, 1, 1, CH), seed=5)
    w, b = rdb_mod.pack_rdb_weights([torch.from_numpy(k) for k in ks],
                                    [torch.from_numpy(v) for v in bs], torch.bfloat16)
    assert w.dtype == torch.bfloat16 and b.dtype == torch.float32
    off = 0
    for k in range(5):
        cin, cout = ks[k].shape[2], ks[k].shape[3]
        got = w[off : off + cin * 9 * cout].float().reshape(cin, 3, 3, cout)
        want = torch.from_numpy(ks[k]).to(torch.bfloat16).float().permute(2, 0, 1, 3)
        assert torch.equal(got, want)
        off += cin * 9 * cout
    assert off == w.numel()
    assert torch.equal(b, torch.cat([torch.from_numpy(v) for v in bs]))
