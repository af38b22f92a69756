"""The port's RDB against the JAX package's.

``rdb_forward_ref`` (the plain version the CUDA kernel is held to on the
card) must compute what the Pallas kernels compute: both entry points run
here in interpret mode, as ``tests/test_pallas_kernels.py`` runs them, and
the Flax ``ResidualDenseBlock`` is the f32 reference. Inputs are made with
numpy from a seed and handed to both frameworks as float32.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu.models.blocks import ResidualDenseBlock as FlaxRDB
from srganfd_tpu.ops.pallas.rdb import rdb_forward_pallas, rdb_forward_pallas_v2
from srganfd_tpu_torch.models.blocks import ResidualDenseBlock
from srganfd_tpu_torch.ops.cuda import rdb as rdb_mod
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

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
    """f32: each HWIO kernel split into TF32 hi and lo halves, in the 3xTF32
    kernel's [cin/8][hi, lo][3*3][cout][8] order with cout zero-padded to a
    multiple of 16; bf16: in the tensor-core kernel's [cin/16][3*3][cout][16]
    order with cin and cout zero-padded to multiples of 16 (here cout = 8
    for convs 1-4 and cin = 24, 40 for convs 1 and 3: half-filled steps);
    biases stay f32."""
    _, ks, bs = _inputs((1, 1, 1, CH), seed=5)
    kernels = [torch.from_numpy(k) for k in ks]
    biases = [torch.from_numpy(v) for v in bs]
    w32, b32 = rdb_mod.pack_rdb_weights(kernels, biases, torch.float32)
    w16, b16 = rdb_mod.pack_rdb_weights(kernels, biases, torch.bfloat16)
    assert w32.dtype == torch.float32 and w16.dtype == torch.bfloat16
    assert b32.dtype == b16.dtype == torch.float32
    off32 = off16 = 0
    for k in range(5):
        cin, cout = ks[k].shape[2], ks[k].shape[3]
        want = torch.from_numpy(ks[k])
        cout_p = -(-cout // 16) * 16
        got = w32[off32 : off32 + 2 * cin * 9 * cout_p].reshape(cin // 8, 2, 3, 3, cout_p, 8)
        padded = torch.zeros(3, 3, cin, cout_p)
        padded[..., :cout] = want
        for part, half in enumerate(rdb_mod.split_tf32(padded)):
            assert torch.equal(got[:, part], half.reshape(3, 3, cin // 8, 8, cout_p).permute(2, 0, 1, 4, 3))
        hi_lo = (got[:, 0] + got[:, 1]).permute(1, 2, 0, 4, 3).reshape(3, 3, cin, cout_p)[..., :cout]
        assert ((hi_lo - want).abs() <= want.abs() * 2.0**-21).all()
        off32 += 2 * cin * 9 * cout_p
        cin_p = -(-cin // 16) * 16
        got = w16[off16 : off16 + cin_p * 9 * cout_p].float().reshape(cin_p // 16, 3, 3, cout_p, 16)
        padded = torch.zeros(3, 3, cin_p, cout_p)
        padded[:, :, :cin, :cout] = want.to(torch.bfloat16).float()
        assert torch.equal(got, padded.reshape(3, 3, cin_p // 16, 16, cout_p).permute(2, 0, 1, 4, 3))
        off16 += cin_p * 9 * cout_p
    assert off32 == w32.numel() and off16 == w16.numel()
    assert torch.equal(b32, torch.cat(biases)) and torch.equal(b16, b32)


def _emulate_bf16_kernel(x, w, b, ch, gc):
    """The bf16 kernel's arithmetic from the packed buffers alone: per conv
    an implicit GEMM over 16-channel steps and the 9 taps of the zero-padded
    halo, reading B[step][tap][cout][16] exactly where the CUDA kernel reads
    it; f32 sums, out_k rounded to bf16, ``y * 0.2 + x`` in f32."""
    n, h, wd, _ = x.shape
    feats = x.float()
    off, boff = 0, 0
    for k in range(5):
        cin, cout = ch + k * gc, (gc if k < 4 else ch)
        cin_p, cout_p = -(-cin // 16) * 16, -(-cout // 16) * 16
        wk = w[off : off + cin_p * 9 * cout_p].float().reshape(cin_p // 16, 9, cout_p, 16)
        src = torch.nn.functional.pad(feats[..., :cin], (0, cin_p - cin, 1, 1, 1, 1))
        acc = torch.zeros(n, h, wd, cout_p)
        for step in range(cin_p // 16):
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                a = src[:, dy : dy + h, dx : dx + wd, step * 16 : step * 16 + 16]
                acc += a @ wk[step, tap].T
        y = acc[..., :cout] + b[boff : boff + cout]
        if k < 4:
            feats = torch.cat([feats, torch.nn.functional.leaky_relu(y, 0.2).bfloat16().float()], -1)
        off += cin_p * 9 * cout_p
        boff += cout
    return (y * 0.2 + x.float()).bfloat16()


@pytest.mark.parametrize("ch,gc", [(CH, GC), (24, 16), (40, 8)], ids=["ch16", "ch24", "ch40"])
def test_packed_bf16_weights_reproduce_the_block(ch, gc):
    """Every packed weight, and the zero padding of half-filled 16-channel
    steps and of couts below 16, lands where the bf16 kernel's loop reads
    it: the emulated kernel equals the plain version up to f32 summation
    order (one bf16 ulp where an out_k rounds the other way)."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(2, 7, 9, ch)).astype(np.float32)).bfloat16()
    kernels, biases = [], []
    for k in range(5):
        cin, cout = ch + k * gc, gc if k < 4 else ch
        kernels.append(torch.from_numpy((rng.normal(size=(3, 3, cin, cout)) * np.sqrt(2 / (9 * cin))).astype(np.float32)))
        biases.append(torch.from_numpy((rng.normal(size=(cout,)) * 0.1).astype(np.float32)))
    w, b = rdb_mod.pack_rdb_weights(kernels, biases, torch.bfloat16)
    got = _emulate_bf16_kernel(x, w, b, ch, gc).float()
    want = rdb_mod.rdb_forward_ref(x, kernels, biases).float()
    torch.testing.assert_close(got, want, atol=1.6e-2, rtol=1.6e-2)
    assert (got - want).abs().mean() <= 1e-3


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize(
    "n,h,w,ch,gc",
    [(1, 256, 256, 64, 32), (16, 72, 72, 64, 32), (8, 60, 60, 64, 32), (3, 17, 70, 64, 32), (1, 8, 8, 64, 16),
     (2, 37, 53, 24, 16), (1, 20, 33, 40, 8), (2, 9, 13, 16, 8)],
    ids=["serve", "bsrnet", "aesrgan", "ragged17x70", "gc16", "ch24", "ch40", "ch16"],
)
def test_forward_plan_against_the_kernels_tiles_and_boxes(n, h, w, ch, gc, sms):
    """``_fwd_plan``, what ``rdb_forward`` passes the bf16 kernel of
    ``csrc/rdb.cu``, against its rules counted here apart: 8x8 pixel tiles;
    tensor-map boxes of 64 channels where every 16-channel step of [x |
    feat] lies in one box of x or of feat (ch a multiple of 64, gc of 16),
    else cp.async halos of ceil(cin / 16) steps; couts in tiles of 32; the
    most ring slots (up to 4) that fit a block's shared memory beside the
    weights; persistent blocks that take every (pixel tile, cout tile) pair
    exactly once."""
    plan = rdb_mod._fwd_plan(n, h, w, ch, gc, sms)
    tiles = n * math.ceil(h / 8) * math.ceil(w / 8)
    tma = ch % 64 == 0 and gc % 16 == 0
    assert (plan["tma"], plan["tiles"]) == (tma, tiles)
    for k, conv in enumerate(plan["convs"]):
        cin, cout = ch + k * gc, gc if k < 4 else ch
        steps = math.ceil(cin / 16)
        if tma:
            # a step's box: x's channels in boxes 0 .. ch / 64 - 1, then feat's
            box = [c // 64 if c < ch else ch // 64 + (c - ch) // 64 for c in range(cin)]
            assert all(len(set(box[s * 16:(s + 1) * 16])) == 1 and box[s * 16] == s // 4 for s in range(steps))
            halo = len(set(box)) * math.ceil(100 * 64 * 2 / 1024) * 1024
        else:
            halo = math.ceil(steps * 2 * 100 * 16 / 1024) * 1024
        w_bytes = steps * 9 * 32 * 16 * 2
        co_tiles = math.ceil(cout / 32)
        smem = lambda ring: 1024 + ring * (halo + 16) + w_bytes  # noqa: E731
        ring, blocks = conv["ring"], conv["blocks"]
        assert (conv["cin"], conv["cout"], conv["co_tiles"], conv["halo"], conv["w"]) == (
            cin, cout, co_tiles, halo, w_bytes)
        assert 2 <= ring <= 4 and conv["smem"] == smem(ring) <= 232448
        assert ring == 4 or smem(ring + 1) > 232448
        assert blocks % co_tiles == 0 and co_tiles <= blocks <= max(sms, co_tiles)
        groups = blocks // co_tiles
        assert groups == min(tiles, max(1, sms // co_tiles))
        # block b takes cout tile b % co_tiles and tiles b // co_tiles, + groups, ..
        taken = [(t, b % co_tiles) for b in range(blocks) for t in range(b // co_tiles, tiles, groups)]
        assert sorted(taken) == [(t, c) for t in range(tiles) for c in range(co_tiles)]
    assert list(plan["args"]) == [int(tma), *(c["blocks"] for c in plan["convs"]),
                                  *(c["ring"] for c in plan["convs"])]


def test_forward_plan_at_the_recipes_width_and_above_it():
    """ch 64, gc 32: halos of 1, 2, 2, 3 and 3 boxes, four ring slots for
    convs 0-2 and three beside the 110,592 bytes of weights of conv 4's cout
    half (221 KB for both halves would leave no room for a halo); widths
    whose weights leave no room for two slots raise."""
    plan = rdb_mod._fwd_plan(1, 256, 256, 64, 32, 132)
    assert [c["halo"] // 13312 for c in plan["convs"]] == [1, 2, 2, 3, 3]
    assert [c["ring"] for c in plan["convs"]] == [4, 4, 4, 3, 3]
    assert [c["co_tiles"] for c in plan["convs"]] == [1, 1, 1, 1, 2]
    assert plan["convs"][4]["w"] == 110592 and [c["blocks"] for c in plan["convs"]] == [132] * 5
    with pytest.raises(ValueError, match="shared memory"):
        rdb_mod._fwd_plan(1, 16, 16, 256, 64, 132)
