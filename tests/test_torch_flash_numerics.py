"""The bf16 flash kernel's arithmetic, emulated on the CPU.

``csrc/flash_attention.cu`` runs its bf16 path on the tensor cores
(``wgmma``), which take bf16 operands. The scores come out in f32 (exact
products of the bf16 q and k, f32 sums), and the probabilities p =
exp2(s * log2(e)/sqrt(D) - m) are f32. For P·V the kernel splits p into two
bf16 values by truncation (hi = p's top 16 bits, lo = those of p - hi) and
pushes both through the tensor cores; the normaliser is the same hi + lo
times a block of ones beside V, summed by the same products.
This file replays that, with 64-key tiles and the online softmax, in
PyTorch on the CPU, and holds it to ``flash_attention_ref`` under the
check that ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` apply to the
kernel on the card:

    |got - want| <= 2**-7 * |want| + 1e-5

(both round one f32 result to bf16, so they may differ by one bf16 ulp).
One case shows that a single bf16 rounding of p, what FlashAttention-2
does, fails that check: the reason for the split.
"""

import math

import numpy as np
import pytest
import torch

from srganfd_tpu_torch.ops.cuda.attention import flash_attention_ref
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TILE = 64  # keys per tile, as FK in the kernel


def _trunc_bf16(x: torch.Tensor) -> torch.Tensor:
    """x with its low 16 bits cleared: a bf16 value, rounded toward zero."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _kernel_emulation(q, k, v, split: bool = True) -> torch.Tensor:
    """q, k, v: (N, T, H, D) bf16. The kernel's tiled online softmax in f32,
    P V and the normaliser both from hi and lo; ``split=False`` rounds p to
    bf16 once instead (and sums the f32 p into the normaliser, as
    FlashAttention-2 does)."""
    n, t, h, d = q.shape
    scale = math.log2(math.e) / math.sqrt(d)
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))  # (N, H, T, D)
    acc = torch.zeros(n, h, t, d)
    l = torch.zeros(n, h, t, 1)
    m = torch.full((n, h, t, 1), -math.inf)
    for k0 in range(0, t, TILE):
        s = qf @ kf[:, :, k0 : k0 + TILE].transpose(-1, -2)  # f32 sums of exact products
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * scale)
        p = torch.exp2(s * scale - m_new * scale)
        vt = vf[:, :, k0 : k0 + TILE]
        if split:
            hi = _trunc_bf16(p)
            lo = _trunc_bf16(p - hi)
            pv = hi @ vt + lo @ vt
            ps = hi.sum(-1, keepdim=True) + lo.sum(-1, keepdim=True)
        else:
            p16 = p.bfloat16().float()
            pv = p16 @ vt
            ps = p.sum(-1, keepdim=True)
        acc = acc * corr + pv
        l = l * corr + ps
        m = m_new
    return (acc / l).permute(0, 2, 1, 3).to(torch.bfloat16)


def _qkv(t: int, d: int, seed: int, heads: int = 4):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(1, t, heads, d)).astype(np.float32)).bfloat16()
            for _ in range(3)]


def _failures(got: torch.Tensor, want: torch.Tensor) -> int:
    got, want = got.float(), want.float()
    return int(((got - want).abs() > want.abs() * 2**-7 + 1e-5).sum())


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("t", [1, 100, 333, 1000])
def test_split_p_meets_the_bf16_check(t, d):
    q, k, v = _qkv(t, d, seed=t + d)
    got = _kernel_emulation(q, k, v)
    want = flash_attention_ref(q, k, v)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _failures(got, want) == 0


def test_split_p_is_close_before_the_output_rounding():
    """hi + lo carries p to < 2^-14 relative: before the final rounding the
    emulation sits within a few 1e-6 of the f32 reference."""
    q, k, v = _qkv(1000, 16, seed=3)
    n, t, h, d = q.shape
    scale = math.log2(math.e) / math.sqrt(d)
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    s = qf @ kf.transpose(-1, -2)
    p = torch.exp2((s - s.amax(-1, keepdim=True)) * scale)
    hi = _trunc_bf16(p)
    lo = _trunc_bf16(p - hi)
    assert ((p - hi - lo).abs() <= p * 2**-14).all()
    got = ((hi + lo) @ vf) / (hi + lo).sum(-1, keepdim=True)
    want = torch.softmax(s / math.sqrt(d), -1) @ vf
    assert (got - want).abs().max().item() < 5e-6


def test_one_bf16_rounding_of_p_fails_the_check():
    """Rounding p to bf16 once before P·V moves some outputs by two bf16
    ulps or more: the check above would fail, which is why the kernel
    splits p."""
    q, k, v = _qkv(1000, 16, seed=7)
    want = flash_attention_ref(q, k, v)
    assert _failures(_kernel_emulation(q, k, v, split=False), want) > 0
    assert _failures(_kernel_emulation(q, k, v, split=True), want) == 0
