"""The filter2d kernel's banded 3xTF32 arithmetic, emulated on the CPU.

``csrc/filter2d.cu`` computes the per-sample reflect-101 correlation on the
tensor cores: for each kernel row dy, the staged input rows times a
Toeplitz band B[j, n] = k[dy, j - n] (8 + K - 1 deep, rounded up to k-steps
of 8), every f32 operand split into TF32 hi + lo and three products taken
per pair, each kernel row's products summed apart and then added to the
running sum, rows of zero taps skipped. No kernel runs here, so this file
checks that arithmetic:

- the emulation, through the port's ``tf32_round``/``split_tf32``, against
  the JAX ``ops.filters.filter2d`` and ``filter2d_pallas`` (interpret
  mode) at the 1e-5 that ``chip_smoke.py`` holds the kernel to; with one
  TF32 product per pair it misses 1e-5; on the chain's zero-padded
  kernels, skipping zero rows changes no bit;
- the per-lane fragment maps of mma.sync.m16n8k8 (PTX ISA) with the
  kernel's k-slot order (slot t = column 2t, slot t + 4 = column 2t + 1):
  B read from the split tap table and A read from the f32 planes and split
  give the band product of every k-step;
- the shared-memory geometry: every K fits a block (two an SM at the
  chain's K), and the reads of A and B are free of bank conflicts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from srganfd_tpu.ops import filters as jax_filters
from srganfd_tpu.ops.pallas.filter2d import filter2d_pallas
from srganfd_tpu_torch.ops.cuda.rdb import split_tf32
from srganfd_tpu_torch.ops.degrade import plan_bsrgan_batch
from test_torch_filter2d import _asymmetric_kernels, _images
from test_torch_tf32_numerics import _a_frag, _b_frag

ATOL = 1e-5  # chip_smoke.py's check of the kernel against filter2d_ref

# csrc/filter2d.cu's tile: G 8-column groups per warp, two m-tiles of 16
# rows, 3 channels staged per pass
G, TW, TH, CP = 10, 80, 32, 3


def _geom(k):
    """``Geom<K>`` of csrc/filter2d.cu."""
    s = (k + 14) // 8
    sw = TW + 8 * (s - 1)
    ld = sw + (40 - sw % 32) % 32
    sh = TH + k - 1
    plane = sh * ld + (42 - sh * ld % 32) % 32
    ne = 8 * s + 8
    return {"S": s, "SW": sw, "LD": ld, "SH": sh, "NE": ne, "PLANE": plane,
            "SMEM": 4 * (2 * k * ne + CP * plane)}


def _band(taps_row, s_steps):
    """B[j, n] = k[j - n] for 0 <= j - n < K, j < 8 S: (N, 8 S, 8)."""
    n, k = taps_row.shape
    band = torch.zeros(n, 8 * s_steps, 8)
    for col in range(8):
        band[:, col:col + k, col] = taps_row
    return band


def _banded_3xtf32(images, kernels, products=3, skip_zero_rows=True):
    """filter2d as the kernel sums it: per kernel row a banded GEMM over
    k-steps of 8 columns, operands split into TF32 halves, ``products`` = 3
    taking lo*hi + hi*lo + hi*hi per pair (1: hi*hi only), each row's
    products in a fresh accumulator added to the total in f32, except that
    a sample's rows of zero taps add nothing (``skip_zero_rows``).
    images (N, H, W, C), kernels (N, K, K) f32 tensors."""
    n, h, w, c = images.shape
    k = kernels.shape[-1]
    s_steps = (k + 14) // 8
    groups = -(-w // 8)
    p = k // 2
    xp = F.pad(images.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
    xp = F.pad(xp, (0, 8 * groups + 8 * (s_steps - 1) - xp.shape[-1]))  # zero past the band's reach
    x_hi, x_lo = split_tf32(xp)
    acc = torch.zeros(n, c, h, groups, 8)
    for dy in range(k):
        b_hi, b_lo = split_tf32(_band(kernels[:, dy], s_steps))
        b_hi, b_lo = b_hi[:, None, None], b_lo[:, None, None]  # (N, 1, 1, 8 S, 8)
        # (N, C, H, groups, 8 S): group gi reads columns 8 gi .. 8 gi + 8 S - 1
        a_hi = x_hi[:, :, dy:dy + h].unfold(-1, 8 * s_steps, 8)
        a_lo = x_lo[:, :, dy:dy + h].unfold(-1, 8 * s_steps, 8)
        part = torch.zeros_like(acc)
        for s in range(s_steps):
            sl = slice(8 * s, 8 * s + 8)
            if products == 3:
                part += a_lo[..., sl] @ b_hi[..., sl, :]
                part += a_hi[..., sl] @ b_lo[..., sl, :]
            part += a_hi[..., sl] @ b_hi[..., sl, :]
        live = (kernels[:, dy] != 0).any(-1) if skip_zero_rows else torch.ones(n, dtype=torch.bool)
        acc = torch.where(live[:, None, None, None, None], acc + part, acc)
    return acc.reshape(n, c, h, 8 * groups)[..., :w].permute(0, 2, 3, 1)


CASES = {
    "k1": (1, None),
    "k3": (3, None),
    "k7": (7, None),
    "k25": (25, None),
    "k31": (31, None),
    "k25_true7": (25, 7),
}


@pytest.mark.parametrize("case", CASES)
def test_banded_3xtf32_matches_jax(case):
    """Ragged 37 x 53 images (neither a multiple of the 32 x 80 tile nor of
    8 columns), asymmetric kernels, and a 7 x 7 kernel zero-padded to 25
    as the chain pads its kernels."""
    k, true_size = CASES[case]
    x = _images((2, 37, 53, 3), seed=10 + k)
    ks = _asymmetric_kernels(2, k, seed=11 + k, true_size=true_size)
    got = _banded_3xtf32(torch.from_numpy(x), torch.from_numpy(ks)).numpy()
    xla = np.asarray(jax_filters.filter2d(jnp.asarray(x), jnp.asarray(ks)))
    pallas = np.asarray(filter2d_pallas(jnp.asarray(x), jnp.asarray(ks), interpret=True))
    np.testing.assert_allclose(got, xla, atol=ATOL, rtol=0, err_msg="filter2d")
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0, err_msg="filter2d_pallas")


def test_the_chains_kernels_skip_zero_rows_exactly():
    """The chain's own kernels (every BSRGAN blur of 7..25 zero-padded to
    25, from ``plan_bsrgan_batch``): skipping a sample's rows of zero taps
    gives the same bits as summing them, and both meet 1e-5 against JAX."""
    ks = plan_bsrgan_batch(np.random.default_rng(3), 3, 2).kernels_a
    assert (np.abs(ks).sum(-1) == 0).any()  # some rows are all zero
    x = torch.from_numpy(_images((3, 29, 34, 3), seed=4))
    skipped = _banded_3xtf32(x, torch.from_numpy(ks))
    summed = _banded_3xtf32(x, torch.from_numpy(ks), skip_zero_rows=False)
    assert torch.equal(skipped, summed)
    want = np.asarray(jax_filters.filter2d(jnp.asarray(x.numpy()), jnp.asarray(ks)))
    np.testing.assert_allclose(skipped.numpy(), want, atol=ATOL, rtol=0)


def test_one_tf32_product_misses_the_check():
    """The split is what keeps f32: one TF32 product per pair (what the
    tensor cores give without it) misses 1e-5 at the chain's K."""
    x = _images((2, 37, 53, 3), seed=20)
    ks = _asymmetric_kernels(2, 25, seed=21)
    want = np.asarray(jax_filters.filter2d(jnp.asarray(x), jnp.asarray(ks)))
    xt, kt = torch.from_numpy(x), torch.from_numpy(ks)
    one = np.abs(_banded_3xtf32(xt, kt, products=1).numpy() - want).max()
    three = np.abs(_banded_3xtf32(xt, kt, products=3).numpy() - want).max()
    assert one > ATOL and three < ATOL / 4, (one, three)


# mma.sync.m16n8k8 fragment maps (``_a_frag``, ``_b_frag``, from the PTX ISA)
# are test_torch_tf32_numerics.py's


def _column(slot):
    """The kernel's k-slot order within a k-step of 8 columns."""
    return 2 * slot if slot < 4 else 2 * (slot - 4) + 1


def _tap_table(taps, s_steps):
    """The kernel's s_tap: per kernel row, entry e holds (hi, lo) of
    k[e - 8], zero outside 0..K-1. (K, NE, 2)."""
    k = taps.shape[0]
    framed = torch.zeros(k, 8 * s_steps + 8)
    framed[:, 8:8 + k] = taps
    return torch.stack(split_tf32(framed), -1)


@pytest.mark.parametrize("k", [1, 3, 25, 31])
def test_b_fragments_from_the_tap_table_are_the_band(k):
    """Each lane's 8-byte reads of entries 8 s + 2 t - g + 8 and the next
    give b0 and b1 of k-step s; placed by the PTX B map and the k-slot
    order, the 32 lanes fill every element of the dense band, hi and lo,
    exactly once."""
    s_steps = _geom(k)["S"]
    taps = torch.from_numpy(_asymmetric_kernels(1, k, seed=30 + k)[0])
    table = _tap_table(taps, s_steps)
    for dy in range(k):
        want_hi, want_lo = split_tf32(_band(taps[None, dy], s_steps)[0])
        got_hi = torch.full((8 * s_steps, 8), float("nan"))
        got_lo = torch.full((8 * s_steps, 8), float("nan"))
        for s in range(s_steps):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for i in range(2):
                    entry = table[dy, 8 * s + 2 * t + i - g + 8]
                    slot, col = _b_frag(lane, i)
                    assert col == g
                    j = 8 * s + _column(slot)
                    assert torch.isnan(got_hi[j, col])
                    got_hi[j, col], got_lo[j, col] = entry[0], entry[1]
        assert torch.equal(got_hi, want_hi) and torch.equal(got_lo, want_lo)


def test_a_fragments_from_the_planes_give_the_band_product():
    """A plane of f32 values with rows of LD floats; lane (g, t) reads 8
    bytes at row g (and g + 8), float 8 f + 2 t: columns 2t and 2t + 1 of
    k-step f, split into a0, a2 (a1, a3) hi and lo. With the B fragments
    of the tap table, the mma of every k-step f - gi of every group gi sums
    to the band product of rows g..g+15."""
    k = 25
    geo = _geom(k)
    s_steps, ld = geo["S"], geo["LD"]
    rng = np.random.default_rng(40)
    rows = torch.from_numpy(rng.uniform(size=(16, geo["SW"])).astype(np.float32))
    taps = torch.from_numpy(_asymmetric_kernels(1, k, seed=41)[0])
    plane = torch.zeros(16, ld)
    plane[:, :geo["SW"]] = rows
    hi, lo = split_tf32(rows)
    table = _tap_table(taps, s_steps)
    dy = 5
    band_hi, band_lo = split_tf32(_band(taps[None, dy], s_steps)[0])
    for gi in (0, 3, G - 1):
        d = torch.zeros(16, 8, dtype=torch.float64)
        for s in range(s_steps):
            f = gi + s
            a = {name: torch.full((16, 8), float("nan"), dtype=torch.float64) for name in ("hi", "lo")}
            b = {name: torch.full((8, 8), float("nan"), dtype=torch.float64) for name in ("hi", "lo")}
            for lane in range(32):
                g, t = lane // 4, lane % 4
                top = split_tf32(plane[g, 8 * f + 2 * t:8 * f + 2 * t + 2])
                bottom = split_tf32(plane[g + 8, 8 * f + 2 * t:8 * f + 2 * t + 2])
                for name, off in (("hi", 0), ("lo", 1)):
                    regs = [top[off][0], bottom[off][0], top[off][1], bottom[off][1]]
                    for i in range(4):
                        a[name][_a_frag(lane, i)] = regs[i]
                    for i in range(2):
                        b[name][_b_frag(lane, i)] = table[dy, 8 * s + 2 * t + i - g + 8, off]
            assert not any(m.isnan().any() for m in (*a.values(), *b.values()))
            d += a["lo"] @ b["hi"] + a["hi"] @ b["lo"] + a["hi"] @ b["hi"]
        window = slice(8 * gi, 8 * gi + 8 * s_steps)
        want = (hi[:, window].double() @ band_lo.double() + lo[:, window].double() @ band_hi.double()
                + hi[:, window].double() @ band_hi.double())
        torch.testing.assert_close(d, want, atol=1e-12, rtol=0)


@pytest.mark.parametrize("k", range(1, 32, 2))
def test_shared_memory_geometry(k):
    """Every K <= 31 fits one block (232,448 bytes) and two an SM up to the
    chain's K = 25, the staged columns cover the band of the last group,
    plane rows are 8 mod 32 floats, and each half-warp's 8-byte reads of A
    (rows g .. g + 3) and of the tap table are free of bank conflicts."""
    geo = _geom(k)
    assert geo["SMEM"] <= 232448
    assert k > 25 or 2 * (geo["SMEM"] + 1024) <= 233472
    assert geo["SW"] >= TW + k - 1 and 8 * (G - 1) + 8 * geo["S"] <= geo["SW"]
    # each m-tile's output takes 16 staged rows of TW columns that only its
    # warps read: rows 0-15 (m-tile 1 reads from row 16) and K+15 .. K+30
    # (m-tile 0 reads up to row K+14)
    assert 16 + k - 1 <= k + 15 and k + 31 <= geo["SH"] and TW <= geo["LD"]
    assert geo["LD"] % 32 == 8 and geo["PLANE"] % 2 == 0
    for f in range(G + geo["S"] - 1):
        for phase in range(2):
            lanes = range(16 * phase, 16 * phase + 16)
            a_words = [(lane // 4) * geo["LD"] + 8 * f + 2 * (lane % 4) for lane in lanes]
            assert len({(wd + i) % 32 for wd in a_words for i in range(2)}) == 32
            for s in range(geo["S"]):
                for j in range(2):
                    e = [8 * s + 2 * (lane % 4) + j - lane // 4 + 8 for lane in lanes]
                    assert 0 <= min(e) and max(e) < geo["NE"]
                    words = {2 * x + i for x in e for i in range(2)}
                    assert len({wd % 32 for wd in words}) == len(words)
