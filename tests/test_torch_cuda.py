"""The port's RDB kernel on the card. Every test here carries the ``cuda``
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
from srganfd_tpu_torch.ops.cuda import rdb as rdb_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the RDB kernel has no CPU mode")
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
@pytest.mark.parametrize("shape,gc", [((2, 9, 13, 16), 8), ((1, 20, 33, 24), 16)],
                         ids=["ch16", "ch24"])
def test_kernel_matches_plain_version(cuda, shape, gc, dtype):
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
    with pytest.raises(RuntimeError, match="no backward"):
        rdb_mod.rdb_forward(x.clone().requires_grad_(), ks, bs)
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
