"""The RDB's backward from the forward's saved activations, on the CPU.

``rdb_backward_ref`` (``ops/cuda/rdb.py``) is the plain version of the
backward kernels (``csrc/rdb_bwd.cu``): it takes the cotangent through the
block from x and the ``feat`` that the forward saved (out_1..out_4),
recomputing nothing. Here it is held to ``jax.vjp`` of the JAX package's
XLA block (``_rdb_xla``, the backward of the JAX ``rdb_apply``), to
autograd through ``rdb_forward_ref`` bit for bit, and ``rdb_apply``'s saved
``feat`` to the plain forward's out_k. The kernels themselves run only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from srganfd_tpu.ops.pallas.rdb import _rdb_xla
from srganfd_tpu_torch.ops.cuda import rdb as rdb_mod
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CH, GC = 16, 8
SHAPE = (2, 9, 11, CH)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=SHAPE).astype(np.float32)
    kernels, biases = [], []
    for k in range(5):
        cin, cout = CH + k * GC, GC if k < 4 else CH
        kernels.append((rng.normal(size=(3, 3, cin, cout)) * np.sqrt(2 / (9 * cin))).astype(np.float32))
        biases.append((rng.normal(size=(cout,)) * 0.1).astype(np.float32))
    cot = rng.normal(size=SHAPE).astype(np.float32)
    return x, kernels, biases, cot


def _leaves(x, kernels, biases, dtype, x_grad=True):
    wdt = torch.float64 if dtype == torch.float64 else torch.float32
    t = torch.from_numpy
    return [t(x).to(dtype).requires_grad_(x_grad), *[t(k).to(wdt).requires_grad_() for k in kernels],
            *[t(b).to(wdt).requires_grad_() for b in biases]]


def test_backward_ref_matches_jax_vjp_of_the_xla_block():
    """f32: dx, the five kernels' and biases' gradients against ``jax.vjp``
    of ``_rdb_xla`` (the JAX ``rdb_apply``'s backward), the same inputs."""
    x, ks, bs, cot = _inputs(seed=1)
    t = torch.from_numpy
    kt, bt = [t(k) for k in ks], [t(b) for b in bs]
    _, feat = rdb_mod.rdb_forward_ref(t(x), kt, bt, with_feat=True)
    dx, dks, dbs = rdb_mod.rdb_backward_ref(t(x), kt, bt, feat, t(cot))
    vjp = jax.jit(lambda x_, k_, b_, c_: jax.vjp(_rdb_xla, x_, k_, b_)[1](c_))  # one compile, not op by op
    wx, wks, wbs = vjp(jnp.asarray(x), tuple(map(jnp.asarray, ks)), tuple(map(jnp.asarray, bs)), jnp.asarray(cot))
    names = ["x"] + [f"kernel{k}" for k in range(5)] + [f"bias{k}" for k in range(5)]
    for name, got, want in zip(names, [dx, *dks, *dbs], [wx, *wks, *wbs]):
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("x_grad", [True, False], ids=["x_grad", "x_no_grad"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64], ids=["f32", "bf16", "f64"])
def test_backward_ref_is_autograd_through_the_plain_forward(dtype, x_grad):
    """From the saved ``feat``, without recomputing the block: bit for bit
    the gradients of autograd through ``rdb_forward_ref`` (the same
    operations, in the same order, with the same rounding points); with x
    not requiring a gradient, no dx and the weights' gradients unchanged."""
    x, ks, bs, cot = _inputs(seed=2)
    leaves = _leaves(x, ks, bs, dtype, x_grad)
    y, feat = rdb_mod.rdb_forward_ref(*(t.detach() for t in leaves[:1]), leaves[1:6], leaves[6:], with_feat=True)
    g = torch.from_numpy(cot).to(dtype)
    dx, dks, dbs = rdb_mod.rdb_backward_ref(leaves[0].detach(), [t.detach() for t in leaves[1:6]],
                                            [t.detach() for t in leaves[6:]], feat, g, want_dx=x_grad)
    wanted = [t for t in leaves if t.requires_grad]
    want = torch.autograd.grad(rdb_mod.rdb_forward_ref(leaves[0], leaves[1:6], leaves[6:]), wanted, g)
    got = ([dx] if x_grad else []) + dks + dbs
    assert (dx is None) == (not x_grad)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rdb_apply_saves_the_plain_forwards_out_k(dtype):
    """``rdb_apply`` on the CPU saves x and ``feat``: out_1..out_4 in x's
    dtype, equal to LeakyReLU of each conv of the dense concat, computed
    here apart from the port's code, and its output is the plain one."""
    x, ks, bs, _ = _inputs(seed=3)
    leaves = _leaves(x, ks, bs, dtype)
    y = rdb_mod.rdb_apply(leaves[0], leaves[1:6], leaves[6:])
    saved_x, feat = y.grad_fn.saved_tensors[:2]
    assert torch.equal(saved_x, leaves[0]) and feat.dtype == dtype and feat.shape == (*SHAPE[:3], 4 * GC)
    src = leaves[0].detach().float().permute(0, 3, 1, 2)
    for k in range(4):
        w = leaves[1 + k].detach().to(dtype).float().permute(3, 2, 0, 1)
        z = F.conv2d(src, w, leaves[6 + k].detach(), padding=1)
        out = torch.where(z >= 0, z, z * 0.2).to(dtype)
        assert torch.equal(feat[..., k * GC:(k + 1) * GC], out.permute(0, 2, 3, 1)), k
        src = torch.cat([src, out.float()], 1)
    assert torch.equal(y, rdb_mod.rdb_forward_ref(*(t.detach() for t in leaves[:1]), leaves[1:6], leaves[6:]))


def test_rdb_apply_without_an_x_gradient():
    """x that needs no gradient: ``rdb_apply``'s backward gives the weights'
    gradients alone, those of autograd through the plain forward."""
    x, ks, bs, cot = _inputs(seed=4)
    a, b = _leaves(x, ks, bs, torch.float32, False), _leaves(x, ks, bs, torch.float32, False)
    g = torch.from_numpy(cot)
    got = torch.autograd.grad(rdb_mod.rdb_apply(a[0], a[1:6], a[6:]), a[1:], g)
    want = torch.autograd.grad(rdb_mod.rdb_forward_ref(b[0], b[1:6], b[6:]), b[1:], g)
    assert all(torch.equal(p, q) for p, q in zip(got, want, strict=True))
    assert a[0].grad is None


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,h,w,ch,gc", [(16, 72, 72, 64, 32), (8, 60, 60, 64, 32), (2, 37, 45, 16, 8),
                                         (1, 5, 3, 24, 16)], ids=["bsrnet", "aesrgan", "ch16", "ch24"])
def test_backward_layout_against_the_kernels_tiles_and_jobs(n, h, w, ch, gc, dtype, sms):
    """``_bwd_layout``, the sizes ``rdb_backward`` passes ``csrc/rdb_bwd.cu``
    and its one scratch allocation, against the kernels' rules counted here
    apart: 8x8 pixel tiles in bf16, 16x8 in f32; bf16 wgrad jobs the (64
    source, 64 DY) channel blocks some conv reads (DY = [dy_4 | dy_0 ..
    dy_3]), f32 jobs each conv in 32 x 32 tiles; the slices; D, DY and the
    partials 256-byte aligned, apart and in order."""
    lay = rdb_mod._bwd_layout(n, h, w, ch, gc, dtype, sms)
    th, tw = (8, 8) if dtype == torch.bfloat16 else (16, 8)
    tiles = n * math.ceil(h / th) * math.ceil(w / tw)
    convs = [(ch + k * gc, gc if k < 4 else ch) for k in range(5)]
    if dtype == torch.bfloat16:
        blocks = set()
        for k, (cin, cout) in enumerate(convs):
            dyo = ch + k * gc if k < 4 else 0
            blocks |= {(ci // 64, (dyo + co) // 64) for ci in range(cin) for co in range(cout)}
        jobs = len(blocks)
    else:
        jobs = sum(math.ceil(cin / 32) * math.ceil(cout / 32) for cin, cout in convs)
    slices = max(1, min(tiles, (1 if dtype == torch.bfloat16 else 4) * sms // jobs))
    elems = sum(9 * cin * cout for cin, cout in convs)
    assert (lay["tiles"], lay["jobs"], lay["slices"], lay["elems"], lay["n_bias"]) == (
        tiles, jobs, slices, elems, 4 * gc + ch)
    px, cd, esize = n * h * w, ch + 4 * gc, 2 if dtype == torch.bfloat16 else 4
    sizes = {"D": 4 * px * cd, "DY": esize * px * cd, "part": 4 * slices * elems, "dbp": 4 * tiles * (4 * gc + ch)}
    at = 0
    for name in ("D", "DY", "part", "dbp"):
        assert lay[name] == at and at % 256 == 0, name
        at += -(-sizes[name] // 256) * 256
    assert lay["bytes"] == at
