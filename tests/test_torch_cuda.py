"""The port's kernels on the card (RDB, flash attention, filter2d, the s8
conv of the int8 serving path), the RDB under autograd and one training
step. Every test here carries the ``cuda``
marker and skips without a CUDA device: a hand-written CUDA kernel has no
CPU mode. On a machine with an NVIDIA GPU (sm_90a) and nvcc, run from the
root of the checkout:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` sets up JAX, which this file
does not use.) Small widths here; ``chip_smoke.py`` holds the kernel to
its plain version at full width.
"""

import math

import pytest
import torch

from srganfd_tpu_torch.models import create_model
from srganfd_tpu_torch.ops.cuda import attention as attn_mod
from srganfd_tpu_torch.ops.cuda import filter2d as f2d_mod
from srganfd_tpu_torch.ops.cuda import qconv as qconv_mod
from srganfd_tpu_torch.ops.cuda import rdb as rdb_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a hand-written CUDA kernel has no CPU mode")
    # f32 convs of the plain version in full f32, as the kernel sums
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, gc, seed, device):
    g = torch.Generator().manual_seed(seed)
    n, h, w, ch = shape
    x = torch.randn(shape, generator=g)
    kernels, biases = [], []
    for k in range(5):
        cin, cout = ch + k * gc, gc if k < 4 else ch
        kernels.append(torch.randn(3, 3, cin, cout, generator=g) * math.sqrt(2.0 / (9 * cin)))
        biases.append(torch.randn(cout, generator=g) * 0.1)
    return x.to(device), [k.to(device) for k in kernels], [b.to(device) for b in biases]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape,gc",
    [((2, 9, 13, 16), 8), ((1, 20, 33, 24), 16), ((16, 72, 72, 64), 32), ((3, 17, 23, 64), 32),
     ((2, 37, 53, 24), 16), ((1, 20, 33, 40), 8), ((2, 19, 13, 24), 8)],
    ids=["ch16", "ch24", "train72", "ragged17x23", "cin24_half_step", "cin40_half_step", "ch24_gc8"],
)
def test_kernel_matches_plain_version(cuda, shape, gc, dtype):
    """Small widths, and the tensor-core kernels' edges: 72 rows (a ragged
    last 16-row tile), 16x8 pixel tiles ragged in both axes, cin = 24, 40,
    ... (a half-filled last 16-channel step in bf16; 8-channel steps in
    f32), and couts of 8 (gc 8: a cout tile of 16 half filled)."""
    x, ks, bs = _inputs(shape, gc, seed=0, device=cuda)
    x = x.to(dtype)
    before = rdb_mod.launches
    got = rdb_mod.rdb_forward(x, ks, bs)
    torch.cuda.synchronize()
    assert rdb_mod.launches == before + 1  # one count per RDB, not per conv
    want = rdb_mod.rdb_forward_ref(x, ks, bs)
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        # the same f32 operands summed in another order
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        # one bf16 ulp at |y| ~ 2: an out_k rounded the other way
        torch.testing.assert_close(got.float(), want.float(), atol=1.6e-2, rtol=1.6e-2)
        assert (got.float() - want.float()).abs().mean() <= 1e-3


def test_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    x, ks, bs = _inputs((1, 8, 8, 16), 8, seed=1, device=cuda)

    def refuse(*args):
        raise AssertionError("a CUDA tensor reached rdb_forward_ref")

    monkeypatch.setattr(rdb_mod, "rdb_forward_ref", refuse)
    assert torch.isfinite(rdb_mod.rdb_forward(x, ks, bs)).all()


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, ks, bs = _inputs((1, 8, 8, 16), 8, seed=2, device=cuda)
    before = rdb_mod.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rdb_mod.rdb_forward(x.half(), ks, bs)
    with pytest.raises(ValueError, match="contiguous"):
        rdb_mod.rdb_forward(x.transpose(1, 2), ks, bs)
    x12, ks12, bs12 = _inputs((1, 8, 8, 12), 8, seed=3, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        rdb_mod.rdb_forward(x12, ks12, bs12)
    assert rdb_mod.launches == before


def test_failed_launch_raises(cuda, monkeypatch):
    class FailingLibrary:
        def rdb_forward_cuda(self, *args):
            return 9  # cudaErrorInvalidConfiguration

        def rdb_error_string(self, code):
            return b"invalid configuration argument"

    x, ks, bs = _inputs((1, 8, 8, 16), 8, seed=4, device=cuda)
    monkeypatch.setattr(rdb_mod, "_library", FailingLibrary)
    before = rdb_mod.launches
    with pytest.raises(RuntimeError, match="invalid configuration"):
        rdb_mod.rdb_forward(x, ks, bs)
    assert rdb_mod.launches == before


@pytest.mark.parametrize("arch", ["bsrgan_x2", "rrdbnet_x4"])
def test_generator_on_cuda_matches_cpu(cuda, arch):
    """The whole generator, kernel RDBs on the card against plain RDBs on
    the CPU, same seeded weights."""
    depth = "num_rrdb" if arch.startswith("bsrgan") else "num_blocks"
    kw = {"channels": 16, "growth_channels": 8, depth: 2}
    model = create_model(arch, generator=torch.Generator().manual_seed(0), **kw).eval()
    with torch.no_grad():  # kaiming without the x0.1, outputs spread over [0, 1]
        for p in model.parameters():
            p.mul_(10)
        model.conv4.bias.add_(0.5)
    x = torch.rand((2, 12, 10, 3), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = model(x)
        before = rdb_mod.launches
        got = model.to(cuda)(x.to(cuda)).cpu()
    assert rdb_mod.launches == before + 3 * 2
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def _qkv(shape, seed, device, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(device, dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape",
    [(2, 100, 4, 16), (1, 333, 8, 32), (1, 128, 2, 16), (3, 1, 1, 32)]
    # the bf16 kernel's edges: 16 queries a warp, 64 a block, 64 keys a tile
    + [(2, t, 4, d) for d in (16, 32) for t in (1, 15, 17, 63, 65, 129)],
    ids=lambda s: "x".join(map(str, s)),
)
def test_flash_kernel_matches_plain_version(cuda, shape, dtype):
    q, k, v = _qkv(shape, 0, cuda, dtype)
    before = attn_mod.launches
    got = attn_mod.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert attn_mod.launches == before + 1
    want = attn_mod.flash_attention_ref(q, k, v)
    assert got.dtype == dtype and got.shape == q.shape and got.is_contiguous()
    if dtype == torch.float32:
        # f32 scores and sums in another order, exp2 of pre-scaled scores
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        # both round one f32 result to bf16: at most one ulp apart
        torch.testing.assert_close(got.float(), want.float(), atol=1e-5, rtol=2**-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernel_reads_strided_views(cuda, dtype):
    """q, k, v as views of one packed (N, T, 3, H, D) projection, as the
    encoder layer passes them (16-byte aligned rows, as both kernels need):
    no copy, the same result."""
    qkv = torch.randn(2, 77, 3, 4, 16, generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
    q, k, v = qkv.unbind(2)
    got = attn_mod.flash_attention(q, k, v)
    want = attn_mod.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_flash_bf16_rejects_rows_not_16_byte_aligned(cuda):
    q, k, v = _qkv((1, 8, 2, 16), 7, cuda, torch.bfloat16)
    shifted = torch.empty(q.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:].view(q.shape)
    shifted.copy_(q)
    strided = torch.empty(1, 8, 2, 20, device=cuda, dtype=torch.bfloat16)[..., :16]  # row stride 20
    strided.copy_(k)
    before = attn_mod.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        attn_mod.flash_attention(shifted, k, v)
    with pytest.raises(ValueError, match="16-byte aligned"):
        attn_mod.flash_attention(q, strided, v)
    assert attn_mod.launches == before
    # f32 rows of 20 elements are 80 bytes: 16-byte aligned
    got = attn_mod.flash_attention(q.float(), strided.float(), v.float())
    torch.testing.assert_close(got, attn_mod.flash_attention_ref(q.float(), strided.float(), v.float()),
                               atol=1e-5, rtol=1e-5)


def test_flash_f32_rejects_rows_not_16_byte_aligned(cuda):
    """The 3xTF32 kernel loads K and V rows 16 bytes at a time: f32 rows
    must start on 16 bytes (element strides multiples of 4)."""
    q, k, v = _qkv((1, 8, 2, 16), 8, cuda)
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    shifted.copy_(k)
    strided = torch.empty(1, 8, 2, 18, device=cuda)[..., :16]  # row stride 18
    strided.copy_(v)
    before = attn_mod.launches
    for args in ((q, shifted, v), (q, k, strided), (shifted, k, v)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            attn_mod.flash_attention(*args)
    assert attn_mod.launches == before


def test_flash_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    q, k, v = _qkv((1, 40, 2, 16), 2, cuda)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached flash_attention_ref")

    monkeypatch.setattr(attn_mod, "flash_attention_ref", refuse)
    assert torch.isfinite(attn_mod.flash_attention(q, k, v)).all()


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv((1, 8, 2, 16), 3, cuda)
    before = attn_mod.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attn_mod.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dims"):
        attn_mod.flash_attention(*_qkv((1, 8, 2, 24), 3, cuda))
    with pytest.raises(ValueError, match="head dims"):
        attn_mod.flash_attention(*(t.requires_grad_() for t in _qkv((1, 8, 2, 24), 3, cuda)))
    assert attn_mod.launches == before


def test_flash_failed_launch_raises(cuda, monkeypatch):
    class FailingLibrary:
        def flash_attention_cuda(self, *args):
            return 9  # cudaErrorInvalidConfiguration

        def flash_attention_error_string(self, code):
            return b"invalid configuration argument"

    monkeypatch.setattr(attn_mod, "_library", FailingLibrary)
    before = attn_mod.launches
    with pytest.raises(RuntimeError, match="invalid configuration"):
        attn_mod.flash_attention(*_qkv((1, 8, 2, 16), 4, cuda))
    assert attn_mod.launches == before


def test_bsrgantrans_on_cuda_matches_cpu(cuda):
    """The whole ``bsrgantrans_x2``, kernels on the card (RDB and flash
    attention) against the plain versions on the CPU, same seeded weights.
    64 channels over 4 heads: the kernel takes head dims 16 and 32."""
    kw = {"channels": 64, "growth_channels": 16, "num_rrdb": 1, "attn_chunk": 32,
          "attn_backend": "flash"}
    model = create_model("bsrgantrans_x2", generator=torch.Generator().manual_seed(0), **kw).eval()
    with torch.no_grad():  # outputs spread over [0, 1]
        for name, p in model.named_parameters():
            if p.dim() == 4:
                p.mul_(10)
        model.conv4.bias.add_(0.5)
    x = torch.rand((2, 12, 10, 3), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = model(x)
        rdb_before, attn_before = rdb_mod.launches, attn_mod.launches
        got = model.to(cuda)(x.to(cuda)).cpu()
    assert rdb_mod.launches == rdb_before + 3
    assert attn_mod.launches == attn_before + 2
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rdb_apply_gradients_on_the_card(cuda, dtype):
    """The kernels under autograd: one forward and one backward call, and
    the gradients of x, the kernels and the biases equal autograd through
    the plain version up to the summation order (the backward kernels' and
    cuDNN's) and, in bf16, the tensor cores' bf16 dy."""
    x, ks, bs = _inputs((2, 12, 10, 16), 8, seed=5, device=cuda)
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(6)).to(cuda, dtype)
    leaves = [x.to(dtype).requires_grad_(), *[t.clone().requires_grad_() for t in ks + bs]]
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    before = rdb_mod.launches, rdb_mod.launches_bwd
    y = rdb_mod.rdb_apply(leaves[0], leaves[1:6], leaves[6:])
    assert rdb_mod.launches == before[0] + 1
    got = torch.autograd.grad(y, leaves, cot)
    assert rdb_mod.launches_bwd == before[1] + 1
    y_ref = rdb_mod.rdb_forward_ref(plain[0], plain[1:6], plain[6:])
    want = torch.autograd.grad(y_ref, plain, cot)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=1e-5 if dtype == torch.float32 else 1.6e-2,
                               rtol=1e-5 if dtype == torch.float32 else 1.6e-2)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert (g.float() - w.float()).abs().max() <= tol * w.float().abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape,gc",
    [((2, 9, 13, 16), 8), ((2, 37, 45, 64), 32), ((1, 20, 33, 24), 16), ((1, 5, 3, 64), 32)],
    ids=["ch16", "ragged37x45", "ch24", "tiny5x3"],
)
def test_rdb_backward_kernels_match_plain_version(cuda, shape, gc, dtype):
    """``csrc/rdb_bwd.cu`` against ``rdb_backward_ref`` on the same saved
    ``feat``, per tensor max |a - b| / max |b|: f32 (3xTF32) to 1e-5 of the
    plain version run in f64, bf16 to 1e-2 (its tensor cores take dy in
    bf16); with and without dx; two runs bit for bit (no atomics)."""
    x, ks, bs = _inputs(shape, gc, seed=7, device=cuda)
    xd = x.to(dtype)
    packed = rdb_mod.pack_rdb_weights(ks, bs, dtype)
    with torch.no_grad():
        _, feat = rdb_mod.rdb_forward_ref(xd, ks, bs, with_feat=True)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(8)).to(cuda, dtype)
    ref_dt = torch.float64 if dtype == torch.float32 else dtype
    for want_dx in (True, False):
        got = rdb_mod.rdb_backward(xd, feat, g, packed, gc, want_dx)
        again = rdb_mod.rdb_backward(xd, feat, g, packed, gc, want_dx)
        want = rdb_mod.rdb_backward_ref(xd.to(ref_dt), [k.to(ref_dt) for k in ks], [b.to(ref_dt) for b in bs],
                                        feat.to(ref_dt), g.to(ref_dt), want_dx)
        assert (got[0] is None) == (not want_dx)
        flat = lambda r: ([r[0]] if want_dx else []) + r[1] + r[2]  # noqa: E731
        for a, a2, w in zip(flat(got), flat(again), flat(want), strict=True):
            assert torch.equal(a, a2)
            err = (a.double() - w.double()).abs().max() / w.double().abs().max()
            assert err <= (1e-5 if dtype == torch.float32 else 1e-2), err


@pytest.mark.parametrize(
    "shape,k",
    [((2, 37, 53, 3), 25), ((3, 20, 24, 3), 7), ((2, 13, 30, 3), 25), ((1, 40, 70, 5), 31),
     ((2, 9, 11, 3), 1), ((16, 64, 64, 3), 25), ((2, 3, 5, 3), 25), ((2, 1, 9, 3), 7), ((48, 8, 8, 3), 21)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else f"k{v}",
)
def test_filter2d_kernel_matches_plain_version(cuda, shape, k):
    """Asymmetric kernels (a flipped kernel fails), ragged tiles, C = 5
    (two channel passes), pads reaching deep into narrow edges, and pads
    wider than the image (K // 2 >= H or W, down to one pixel), where the
    reflection folds again as ``jnp.pad(mode="reflect")`` folds it."""
    g = torch.Generator().manual_seed(7)
    x = torch.rand(shape, generator=g).to(cuda)
    ks = torch.rand((shape[0], k, k), generator=g)
    ks = (ks / ks.sum(dim=(1, 2), keepdim=True)).to(cuda)
    before = f2d_mod.launches
    got = f2d_mod.filter2d(x, ks)
    torch.cuda.synchronize()
    assert f2d_mod.launches == before + 1
    assert got.shape == x.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, f2d_mod.filter2d_ref(x, ks), atol=1e-5, rtol=0)


def test_filter2d_kernel_on_the_chains_kernels(cuda):
    """The chain's own kernels (every BSRGAN blur of 7..25 zero-padded to
    25): the kernel skips their rows of zero taps and matches the plain
    version all the same."""
    import numpy as np

    from srganfd_tpu_torch.ops.degrade import plan_bsrgan_batch

    ks = torch.from_numpy(plan_bsrgan_batch(np.random.default_rng(9), 4, 2).kernels_b).to(cuda)
    x = torch.rand((4, 50, 90, 3), generator=torch.Generator().manual_seed(9)).to(cuda)
    got = f2d_mod.filter2d(x, ks)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, f2d_mod.filter2d_ref(x, ks), atol=1e-5, rtol=0)


def test_filter2d_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    def refuse(*args):
        raise AssertionError("a CUDA tensor reached filter2d_ref")

    monkeypatch.setattr(f2d_mod, "filter2d_ref", refuse)
    x = torch.rand((1, 16, 16, 3), device=cuda)
    assert torch.isfinite(f2d_mod.filter2d(x, torch.rand((1, 5, 5), device=cuda))).all()


def test_filter2d_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.rand((1, 40, 40, 3), device=cuda)
    before = f2d_mod.launches
    with pytest.raises(TypeError, match="float32"):
        f2d_mod.filter2d(x.double(), torch.rand((1, 5, 5), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="K <= 31"):
        f2d_mod.filter2d(x, torch.rand((1, 33, 33), device=cuda))
    with pytest.raises(ValueError, match="K odd"):
        f2d_mod.filter2d(x, torch.rand((1, 4, 4), device=cuda))
    assert f2d_mod.launches == before


def test_filter2d_failed_launch_raises(cuda, monkeypatch):
    class FailingLibrary:
        def filter2d_cuda(self, *args):
            return 9  # cudaErrorInvalidConfiguration

        def filter2d_error_string(self, code):
            return b"invalid configuration argument"

    monkeypatch.setattr(f2d_mod, "_library", FailingLibrary)
    before = f2d_mod.launches
    with pytest.raises(RuntimeError, match="invalid configuration"):
        f2d_mod.filter2d(torch.rand((1, 8, 8, 3), device=cuda), torch.rand((1, 3, 3), device=cuda))
    assert f2d_mod.launches == before


def test_train_step_with_kernels_matches_plain_versions(cuda, monkeypatch):
    """One f32 bsrnet step at small widths, once with the RDB and filter2d
    kernels and once with their plain versions, from the same state and
    batch: the same loss and the same updated G."""
    import numpy as np

    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
    from srganfd_tpu_torch.models import blocks
    from srganfd_tpu_torch.ops import filters
    from srganfd_tpu_torch.train.loop import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_config("bsrnet", compute_dtype="float32", gt_image_size=32,
                             g_kwargs={"channels": 16, "growth_channels": 8, "num_rrdb": 2})
    host = {"gt": np.random.default_rng(8).uniform(size=(2, 64, 64, 3)).astype(np.float32)}
    results = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(blocks, "rdb_apply",
                                lambda x, k, b, packed=None: rdb_mod.rdb_forward_ref(x, k, b))
            monkeypatch.setattr(filters, "filter2d", f2d_mod.filter2d_ref)
        trainer = Trainer(cfg, device=cuda)
        state = trainer.init_state()
        launches = (rdb_mod.launches, f2d_mod.launches)
        batch = DegradationAdapter(cfg, seed=0, train=True, device=cuda)(host, 0)
        loss = trainer.train_step(state, batch["gt"], batch["lr"])["pixel_loss"].item()
        made = (rdb_mod.launches - launches[0], f2d_mod.launches - launches[1])
        assert made == ((0, 0) if plain else (6, 2))
        results.append((loss, {k: v.detach().cpu() for k, v in state.g_model.state_dict().items()}))
    (loss_k, g_k), (loss_p, g_p) = results
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for k in g_p:
        torch.testing.assert_close(g_k[k], g_p[k], atol=1e-7, rtol=1e-5)


def _int8(shape, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(device)


@pytest.mark.parametrize(
    "shape,cin,cout",
    [((1, 9, 13), 32, 8), ((2, 17, 23), 64, 192), ((1, 16, 8), 32, 160), ((3, 5, 37), 96, 40), ((1, 1, 1), 32, 64)],
    ids=["cout8", "x_source", "out1_source", "ragged_cin96", "one_pixel"],
)
def test_qconv_kernel_equals_plain_version(cuda, shape, cin, cout):
    """The s8 conv bit for bit: its int32 sums and its f32 output, over
    ragged 16x8 tiles, cout tiles of 64 partly filled and cin of 1-3 steps."""
    xq, kq = _int8((*shape, cin), 0, cuda), _int8((3, 3, cin, cout), 1, cuda)
    scale = torch.rand(cout, generator=torch.Generator().manual_seed(2)).to(cuda) * 1e-4
    before = qconv_mod.launches
    got_i, got_f = qconv_mod.qconv3x3(xq, kq), qconv_mod.qconv3x3(xq, kq, scale)
    torch.cuda.synchronize()
    assert qconv_mod.launches == before + 2
    assert torch.equal(got_i, qconv_mod.qconv3x3_ref(xq, kq))
    assert torch.equal(got_f, qconv_mod.qconv3x3_ref(xq, kq, scale))


def test_qconv_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    def refuse(*args):
        raise AssertionError("a CUDA tensor reached qconv3x3_ref")

    monkeypatch.setattr(qconv_mod, "qconv3x3_ref", refuse)
    out = qconv_mod.qconv3x3(_int8((1, 4, 4, 32), 3, cuda), _int8((3, 3, 32, 8), 4, cuda))
    assert out.dtype == torch.int32 and out.shape == (1, 4, 4, 8)


def test_qconv_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    before = qconv_mod.launches
    with pytest.raises(ValueError, match="multiple of 32"):
        qconv_mod.qconv3x3(_int8((1, 4, 4, 16), 5, cuda), _int8((3, 3, 16, 8), 6, cuda))
    with pytest.raises(ValueError, match="multiple of 8"):
        qconv_mod.qconv3x3(_int8((1, 4, 4, 32), 5, cuda), _int8((3, 3, 32, 12), 6, cuda))
    with pytest.raises(TypeError, match="int8"):
        qconv_mod.qconv3x3(_int8((1, 4, 4, 32), 5, cuda).float(), _int8((3, 3, 32, 8), 6, cuda))
    with pytest.raises(ValueError, match="contiguous"):
        qconv_mod.qconv3x3(_int8((1, 4, 32, 4), 5, cuda).transpose(2, 3), _int8((3, 3, 32, 8), 6, cuda))
    assert qconv_mod.launches == before


def test_qconv_failed_launch_raises(cuda, monkeypatch):
    class FailingLibrary:
        def qconv3x3_s8_cuda(self, *args):
            return 9  # cudaErrorInvalidConfiguration

        def qconv_error_string(self, code):
            return b"invalid configuration argument"

    monkeypatch.setattr(qconv_mod, "_library", FailingLibrary)
    before = qconv_mod.launches
    with pytest.raises(RuntimeError, match="invalid configuration"):
        qconv_mod.qconv3x3(_int8((1, 4, 4, 32), 7, cuda), _int8((3, 3, 32, 8), 8, cuda))
    assert qconv_mod.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quantized_generator_on_cuda_matches_plain_qconv(cuda, dtype, monkeypatch):
    """``bsrgan_x2`` with ``quant=True`` at 32/32 (the kernel takes cin in
    multiples of 32) on the card, with the kernel and again with the plain
    qconv on the same device: the int32 sums are exact in both, so the
    outputs agree to f32 roundoff (the CPU is no reference here: its f32
    convs outside the trunk round apart, and one flipped activation
    rounding moves an output by a quantization step)."""
    from srganfd_tpu_torch.ops import quant

    model = create_model("bsrgan_x2", dtype=dtype, quant=True, generator=torch.Generator().manual_seed(0),
                         channels=32, growth_channels=32, num_rrdb=1).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(10)
        model.conv4.bias.add_(0.5)
    model = model.to(cuda)
    x = torch.rand((2, 12, 10, 3), generator=torch.Generator().manual_seed(1)).to(cuda)
    with torch.inference_mode():
        before = qconv_mod.launches
        got = model(x)
        assert qconv_mod.launches == before + 5 * 3
        monkeypatch.setattr(quant, "qconv3x3", lambda xq, kq, s=None, packed=None: qconv_mod.qconv3x3_ref(xq, kq, s))
        want = model(x)
    assert qconv_mod.launches == before + 5 * 3
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
