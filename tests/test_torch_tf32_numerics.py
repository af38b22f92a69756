"""The f32 kernels' split-precision 3xTF32 arithmetic, emulated on the CPU.

The f32 paths of ``csrc/rdb.cu`` and ``csrc/flash_attention.cu`` run on the
tensor cores, whose f32 mode (TF32) keeps 10 mantissa bits. Each operand is
split into two TF32 values, a ~ hi + lo, and each product taken as
a_lo b_hi + a_hi b_lo + a_hi b_hi in f32. This file checks that arithmetic
here, where no kernel runs:

- the rounding (``cvt.rna.tf32.f32``, computed with integer operations in
  the kernels and in ``ops/cuda/rdb.py`` ``tf32_round``) and the split;
- the RDB kernel's implicit GEMM replayed from the packed f32 buffer alone,
  with three products, against ``rdb_forward_ref``; with one product it
  misses the 1e-4 check that ``chip_smoke.py`` holds the kernel to;
- the mma.sync.m16n8k8 fragment maps of the PTX ISA, the ldmatrix reads
  that deliver them, and the flash kernel's relabelling of keys that feeds
  the S accumulator to P V without shuffles;
- the flash kernel's tiled online softmax with 3xTF32 products against
  ``flash_attention_ref`` under the f32 check, 1e-5;
- that the views the encoder layer hands the flash kernel meet its 16-byte
  row alignment.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from srganfd_tpu_torch.models import blocks
from srganfd_tpu_torch.ops.cuda import attention as attn_mod
from srganfd_tpu_torch.ops.cuda import rdb as rdb_mod
from srganfd_tpu_torch.ops.cuda.rdb import split_tf32, tf32_round


def _spread_f32(n: int, seed: int) -> torch.Tensor:
    """Normal values times 10^[-20, 20], both signs."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=n) * 10.0 ** rng.uniform(-20, 20, n)).astype(np.float32))


def test_tf32_round_is_nearest_with_ties_away_from_zero():
    x = _spread_f32(100_000, seed=0)
    r = tf32_round(x)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()  # 10 explicit mantissa bits
    _, e = torch.frexp(x.double())  # |x| in [2^(e-1), 2^e): a TF32 ulp is 2^(e-11)
    half_ulp = torch.ldexp(torch.ones_like(e, dtype=torch.float64), e - 12)
    assert ((x.double() - r.double()).abs() <= half_ulp).all()
    one = np.float32(1.0)
    ties = torch.from_numpy(np.array([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-11 - 2.0**-23,
                                      1 + 3 * 2.0**-11], dtype=np.float32))
    want = torch.from_numpy(np.array([1 + 2.0**-10, -(1 + 2.0**-10), one, 1 + 2.0**-9], dtype=np.float32))
    assert torch.equal(tf32_round(ties), want)  # round-to-even would give 1 for the first


def test_split_reconstructs_f32():
    x = _spread_f32(100_000, seed=1)
    hi, lo = split_tf32(x)
    for half in (hi, lo):
        assert ((half.view(torch.int32) & 0x1FFF) == 0).all()
    rel = ((x.double() - hi.double() - lo.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0**-21
    assert torch.equal(hi + lo - hi, lo)  # lo is far below hi: no overlap


def _rdb_weights(rng, ch, gc, gain=1.0):
    kernels, biases = [], []
    for k in range(5):
        cin, cout = ch + k * gc, gc if k < 4 else ch
        w = rng.normal(size=(3, 3, cin, cout)) * math.sqrt(2 / (9 * cin)) * gain
        kernels.append(torch.from_numpy(w.astype(np.float32)))
        biases.append(torch.from_numpy((rng.normal(size=(cout,)) * 0.1).astype(np.float32)))
    return kernels, biases


def _emulate_f32_kernel(x, w, b, ch, gc, products=3):
    """The f32 kernel's arithmetic from the packed buffers alone: per conv an
    implicit GEMM over 8-channel steps and the 9 taps of the zero-padded
    halo, A split into TF32 halves, B read from [step][hi, lo][tap][cout][8]
    where the kernel reads it; ``products`` = 3 takes a_lo b_hi + a_hi b_lo +
    a_hi b_hi, 1 only a_hi b_hi (plain TF32). As in the kernel, each step's
    products are summed apart and added to the total after the step. Bias,
    LeakyReLU and ``y * 0.2 + x`` in f32."""
    n, h, wd, _ = x.shape
    feats = x
    off = boff = 0
    for k in range(5):
        cin, cout = ch + k * gc, (gc if k < 4 else ch)
        cout_p = -(-cout // 16) * 16
        wk = w[off : off + 2 * 9 * cin * cout_p].reshape(cin // 8, 2, 9, cout_p, 8)
        src = F.pad(feats[..., :cin], (0, 0, 1, 1, 1, 1))
        acc = torch.zeros(n, h, wd, cout_p)
        for step in range(cin // 8):
            part = torch.zeros(n, h, wd, cout_p)
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                a_hi, a_lo = split_tf32(src[:, dy : dy + h, dx : dx + wd, step * 8 : step * 8 + 8])
                b_hi, b_lo = wk[step, 0, tap].T, wk[step, 1, tap].T
                if products == 3:
                    part += a_lo @ b_hi + a_hi @ b_lo
                part += a_hi @ b_hi
            acc += part
        y = acc[..., :cout] + b[boff : boff + cout]
        if k < 4:
            feats = torch.cat([feats, F.leaky_relu(y, 0.2)], -1)
        off += 2 * 9 * cin * cout_p
        boff += cout
    assert off == w.numel()
    return y * 0.2 + x


@pytest.mark.parametrize("ch,gc", [(16, 8), (24, 16), (40, 8), (24, 8)],
                         ids=["ch16_gc8", "ch24_gc16", "ch40_gc8", "ch24_gc8"])
def test_packed_f32_weights_reproduce_the_block(ch, gc):
    """Every packed hi and lo weight, and the zero padding of couts below
    16 (gc 8) and of cout tiles that 24 or 40 channels half fill, lands
    where the f32 kernel reads it: three TF32 products per pair give the
    plain f32 block within 1e-5."""
    rng = np.random.default_rng(20 + ch + gc)
    x = torch.from_numpy(rng.normal(size=(2, 7, 9, ch)).astype(np.float32))
    kernels, biases = _rdb_weights(rng, ch, gc)
    w, b = rdb_mod.pack_rdb_weights(kernels, biases, torch.float32)
    got = _emulate_f32_kernel(x, w, b, ch, gc)
    torch.testing.assert_close(got, rdb_mod.rdb_forward_ref(x, kernels, biases), atol=1e-5, rtol=0)


def test_one_tf32_product_misses_the_f32_check():
    """At the serving block's widths (ch 64, gc 32) and magnitudes (x ~ N(0,
    1), kaiming weights), one TF32 product per pair moves the output by
    more than the 1e-4 that chip_smoke.py allows: the reason for three."""
    rng = np.random.default_rng(30)
    x = torch.from_numpy(rng.normal(size=(1, 10, 12, 64)).astype(np.float32))
    kernels, biases = _rdb_weights(rng, 64, 32)
    w, b = rdb_mod.pack_rdb_weights(kernels, biases, torch.float32)
    want = rdb_mod.rdb_forward_ref(x, kernels, biases)
    one = (_emulate_f32_kernel(x, w, b, 64, 32, products=1) - want).abs().max().item()
    three = (_emulate_f32_kernel(x, w, b, 64, 32, products=3) - want).abs().max().item()
    assert one > 1e-4 and three < 1e-5, (one, three)


# -- mma.sync.m16n8k8 (.tf32, f32 accumulate) fragments, from the PTX ISA ----
# g = lane / 4, t = lane % 4; each returns (row, column) of register i


def _a_frag(lane, i):  # A, 16 x 8, row-major
    return lane // 4 + 8 * (i & 1), lane % 4 + 4 * (i >> 1)


def _b_frag(lane, i):  # B, 8 (k) x 8 (n)
    return lane % 4 + 4 * i, lane // 4


def _c_frag(lane, i):  # C and D, 16 x 8
    return lane // 4 + 8 * (i >> 1), 2 * (lane % 4) + (i & 1)


def _mma(a_regs, b_regs):
    """D = A B from the 32 lanes' registers, every element placed once."""
    a, b = torch.full((16, 8), math.nan, dtype=torch.float64), torch.full((8, 8), math.nan, dtype=torch.float64)
    for lane in range(32):
        for i in range(4):
            a[_a_frag(lane, i)] = a_regs[lane][i]
        for i in range(2):
            b[_b_frag(lane, i)] = b_regs[lane][i]
    assert not a.isnan().any() and not b.isnan().any()
    return a @ b


def test_s_registers_feed_p_v_with_relabelled_keys():
    """The S accumulator registers {c0, c2, c1, c3} as the A fragment, with
    k-slot t read as key 2t and slot t + 4 as key 2t + 1, and V rows 2t and
    2t + 1 as the B fragment: P V exactly, no shuffle."""
    rng = np.random.default_rng(40)
    s = torch.from_numpy(rng.integers(-8, 8, size=(16, 8)).astype(np.float64))  # 16 rows x 8 keys
    v = torch.from_numpy(rng.integers(-8, 8, size=(8, 8)).astype(np.float64))   # 8 keys x 8 d
    c = [[s[_c_frag(lane, i)] for i in range(4)] for lane in range(32)]
    a = [[c[lane][0], c[lane][2], c[lane][1], c[lane][3]] for lane in range(32)]
    key = lambda slot: 2 * slot if slot < 4 else 2 * (slot - 4) + 1
    b = [[v[key(_b_frag(lane, i)[0]), _b_frag(lane, i)[1]] for i in range(2)] for lane in range(32)]
    assert torch.equal(_mma(a, b), s @ v)
    # without the relabelling the same registers give another product
    b_plain = [[v[_b_frag(lane, i)] for i in range(2)] for lane in range(32)]
    assert not torch.equal(_mma(a, b_plain), s @ v)


def _ldmatrix_x4(rows_of_lanes, mem):
    """ldmatrix.x4.b16 on 16-byte rows of 4 f32: lane L gives the row address
    of matrix L / 8; register j of lane L is 32-bit word L % 4 of row L / 4
    of matrix j. ``rows_of_lanes[L]`` = (row, 16-byte unit) in ``mem``."""
    regs = []
    for lane in range(32):
        out = []
        for j in range(4):
            row, unit = rows_of_lanes[8 * j + lane // 4]
            out.append(mem[row, unit * 4 + lane % 4])
        regs.append(out)
    return regs


def test_ldmatrix_of_f32_rows_delivers_the_tf32_fragments():
    """The RDB kernel's ldmatrix lane roles on 32-byte rows of 8 f32
    channels: A (16 pixels x 8 channels) lands in a0-a3, and B (16 couts x
    8 channels) in b0, b1 of two n-tiles."""
    rng = np.random.default_rng(41)
    pix = torch.from_numpy(rng.normal(size=(16, 8)))  # pixels: first output row 0-7, second 8-15
    a_rows = [((lane & 7) + 8 * ((lane >> 3) & 1), lane >> 4) for lane in range(32)]
    for lane, regs in enumerate(_ldmatrix_x4(a_rows, pix)):
        assert regs == [pix[_a_frag(lane, i)] for i in range(4)]
    wt = torch.from_numpy(rng.normal(size=(16, 8)))  # couts x channels
    b_rows = [(((lane >> 4) << 3) + (lane & 7), (lane >> 3) & 1) for lane in range(32)]
    for lane, regs in enumerate(_ldmatrix_x4(b_rows, wt)):
        for nt in range(2):
            want = [wt[8 * nt + _b_frag(lane, i)[1], _b_frag(lane, i)[0]] for i in range(2)]
            assert regs[2 * nt : 2 * nt + 2] == want


def test_shared_memory_layouts_are_free_of_bank_conflicts():
    """RDB: 8 consecutive 32-byte pixel or weight rows at one 16-byte half
    (one ldmatrix phase) fall into 8 distinct 16-byte bank groups after
    ``unit2``'s XOR. Flash: K and V are stored as (hi, lo) word pairs in
    rows of LK = 2 (D + 4) and LV = 2 (D + 2) words; the 64-bit fragment
    reads of each half-warp, K (key g, d t) and V (key 2t, d g), cover 32
    distinct banks, and rows stay 16-byte aligned for the staging stores."""
    unit2 = lambda r, half: r * 2 + (half ^ ((r >> 2) & 1))
    for r0 in range(64):
        for half in (0, 1):
            assert len({unit2(r0 + i, half) % 8 for i in range(8)}) == 8
    for d in (16, 32):
        lk, lv = 2 * (d + 4), 2 * (d + 2)
        for half_warp in (range(16), range(16, 32)):
            k_words = [(lane // 4) * lk + 2 * (lane % 4) for lane in half_warp]
            v_words = [2 * (lane % 4) * lv + 2 * (lane // 4) for lane in half_warp]
            for words in (k_words, v_words):
                assert len({(w + i) % 32 for w in words for i in (0, 1)}) == 32
        assert lk * 4 % 16 == 0 and lv * 4 % 16 == 0


def _flash_emulation(q, k, v, products=3, tile=64):
    """The f32 flash kernel: 64-key tiles, online softmax, exp2 of the
    scaled raw scores, every product in split TF32 (three per pair, or one),
    each tile's P V added to the running sum in f32. q/k/v: (N, T, H, D)."""
    n, t, h, d = q.shape
    scale = math.log2(math.e) / math.sqrt(d)
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    (qh, ql), (kh, kl), (vh, vl) = split_tf32(qf), split_tf32(kf), split_tf32(vf)

    def prod(ah, al, bh, bl):
        return al @ bh + ah @ bl + ah @ bh if products == 3 else ah @ bh

    acc = torch.zeros(n, h, t, d)
    l = torch.zeros(n, h, t, 1)
    m = torch.full((n, h, t, 1), -math.inf)
    for k0 in range(0, t, tile):
        sl = slice(k0, k0 + tile)
        s = prod(qh, ql, kh[:, :, sl].transpose(-1, -2), kl[:, :, sl].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * scale)
        p = torch.exp2(s * scale - m_new * scale)
        acc = acc * corr + prod(*split_tf32(p), vh[:, :, sl], vl[:, :, sl])
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
    return (acc / l).permute(0, 2, 1, 3)


def _qkv(t, d, seed, heads=4):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(1, t, heads, d)).astype(np.float32)) for _ in range(3)]


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("t", [1, 65, 333])
def test_3xtf32_flash_meets_the_f32_check(t, d):
    q, k, v = _qkv(t, d, seed=50 + t + d)
    torch.testing.assert_close(_flash_emulation(q, k, v), attn_mod.flash_attention_ref(q, k, v),
                               atol=1e-5, rtol=1e-5)


def test_one_tf32_product_misses_the_flash_check():
    q, k, v = _qkv(333, 16, seed=60)
    want = attn_mod.flash_attention_ref(q, k, v)
    err = (_flash_emulation(q, k, v, products=1) - want).abs()
    assert (err > 1e-5 + 1e-5 * want.abs()).any()


def test_encoder_views_meet_the_flash_alignment(monkeypatch):
    """The q, k, v views that ``SelfAttention`` cuts from its packed f32
    projection (T stride 3 H D, k and v offset by H D and 2 H D elements)
    pass the kernel's 16-byte row check; a view shifted by one element
    does not."""
    seen = []

    def checked(q, k, v):
        attn_mod._check(q, k, v)
        seen.append(tuple(t.stride() for t in (q, k, v)))
        return attn_mod.flash_attention_ref(q, k, v)

    monkeypatch.setattr(blocks, "flash_attention", checked)
    layer = blocks.SelfAttention(64, 4, attn_chunk=16, backend="flash")
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(61)) * 0.1)
        layer(torch.randn(2, 37, 64, generator=torch.Generator().manual_seed(62)))
    assert seen == [((37 * 192, 192, 16, 1),) * 3]
    base = torch.zeros(1, 8, 2, 16 + 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        attn_mod._check(base[..., 1:], base[..., :16], base[..., :16])
