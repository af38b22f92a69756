// Per-sample 2-D filter for Hopper (sm_90a) on the tensor cores, bound
// through ctypes.
//
// Replaces the TPU kernel `filter2d_pallas` (srganfd_tpu/ops/pallas/filter2d.py,
// body `_filter_kernel`), which computes `ops.filters.filter2d`, the blur of
// the BSRGAN degradation chain:
//
//   out[n, h, w, c] = sum_{dy, dx} xpad[n, h + dy, w + dx, c] * k[n, dy, dx]
//
// images (N, H, W, C) f32 channels-last, kernels (N, K, K) f32 with K odd,
// xpad the image reflect-101-padded by K/2 on both spatial axes as
// jnp.pad(mode="reflect") pads: the edge pixel is not repeated, the fold
// repeats where K/2 reaches past the axis, and an axis of one pixel
// repeats it. A correlation: the kernel is not flipped. f32 operands and
// sums (the JAX chain asks for Precision.HIGHEST).
//
// Bound at the chain's shape, (16, 320, 320, 3) with K = 25: 16 * 320 *
// 320 * 3 * 625 MAC = 6.14e9 FLOP, 0.092 ms at the H100's 67 TFLOP/s f32
// CUDA-core peak, or 0.037 ms as three TF32 products per pair at 495
// TFLOP/s, against 0.012 ms for the 2 x 19.7 MB that must move at 3.35
// TB/s: bound by the operations. On the chain's own kernels (rows of zero
// taps skipped, below) the operations are those of the nonzero rows.
//
// Design: a banded GEMM per kernel row on mma.sync.m16n8k8 TF32, in
// split-precision 3xTF32. For kernel row dy and 8 output columns from x0,
//   out[y, x0 + n] += sum_j A[y, j] B[j, n],
//   A[y, j] = xpad[y + dy, x0 + j],  B[j, n] = k[dy, j - n] (0 outside 0..K-1),
// a Toeplitz band of depth 8 + K - 1, rounded up to S k-steps of 8 (32 for
// K = 25: 25 of every 32 issued products are useful). B does not depend on
// x0 or y, so a warp reads each B fragment once per kernel row for all its
// output columns; A fragments of adjacent 8-column groups overlap (k-step
// s of group g + 1 is k-step s + 1 of group g), so a warp computing G = 10
// groups reads G + S - 1 A fragments per kernel row for G * S k-steps. The
// TPU kernel's bands as wide as the image (work x (W + K - 1) / K) are not
// carried over.
//
// - 3xTF32: every operand x ~ hi + lo, both TF32 (tf32_rna below, the
//   rounding of csrc/rdb.cu); each pair takes lo*hi + hi*lo + hi*hi. The
//   taps are split once per block into a (hi, lo) table; an A value is
//   split when its fragment is read (8-byte shared-memory reads of f32:
//   half the traffic of staged (hi, lo) pairs, and the planes fit two
//   blocks an SM). Each kernel row's products go into a fresh accumulator
//   that is then added to the running sum in f32: the tensor cores' f32
//   accumulation does not round to nearest, and its error grows with the
//   chain.
// - k-slot order: in each k-step, mma k-slot t holds column 2t and slot
//   t + 4 column 2t + 1, so a lane's a0/a2 (and a1/a3) are adjacent
//   columns, one 8-byte read; b0 = k[dy, 8s + 2t - g], b1 = k[dy, 8s + 2t +
//   1 - g] (g = lane / 4, t = lane % 4), two adjacent table entries.
// - Issue order: a warp issues in order, so each A fragment's products go
//   round the (up to S) groups that use it before the next product: one
//   accumulator is not written by two mma in a row.
// - Rows of zero taps are skipped (a warp vote per kernel row): on finite
//   input they add nothing, and the chain's kernels of 7..25 zero-padded
//   to 25 have 57% of their rows nonzero. (On Inf or NaN input the plain
//   version can give NaN where the kernel does not.)
// - Tiles: one block per (sample, 32 x 80 output tile), six warps, one per
//   (16-row m-tile, channel), up to 3 channels staged together (C = 3 in
//   the chain; wider C takes several passes); two blocks an SM for K <= 31
//   (78 KB of shared memory at K = 25), so one block's staging overlaps
//   the other's products.
// - Staging: the tile and its K - 1 halo, (32 + K - 1) rows of 80 + 8(S - 1)
//   columns, one pixel (its channels) a thread, adjacent threads on
//   adjacent pixels, each channel into its own f32 plane; reflect-101 is
//   resolved during the load, so no padded copy is made. A block whose
//   staged rows and columns all lie within one fold of the image (every
//   block where K/2 < H and W, but for the halo of a ragged last tile on
//   small images) reflects with two selects; any other block stages with
//   the periodic fold, whose integer modulo per staged pixel would slow
//   the common case. Plane rows are 8
//   mod 32 floats, so a half-warp's 8-byte A reads (rows g .. g + 3) cover
//   all 32 banks.
// - Stores go straight from the accumulators, masked at ragged edges.
//   Measured against the alternatives (PERF.md, section 6): 16-byte staging
//   loads, one float a thread, a persistent kernel staging the next tile
//   with cp.async, and the output written through shared memory as
//   contiguous runs were each slower at the chain's K = 25.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KMAX = 31;               // largest K taken
constexpr int G = 10;                  // 8-column groups per warp
constexpr int TW = 8 * G;              // output tile columns: 80
constexpr int MT = 2;                  // 16-row m-tiles per tile
constexpr int TH = 16 * MT;            // output tile rows: 32
constexpr int CP = 3;                  // channels staged per pass
constexpr int WARPS = MT * CP;         // one per (m-tile, channel)
constexpr int THREADS = 32 * WARPS;    // 192
constexpr int UNROLL = 8;              // staged pixels in flight per thread

template <int K>
struct Geom {
  static constexpr int PAD = K / 2;
  static constexpr int S = (K + 14) / 8;       // k-steps of a band: ceil((8 + K - 1) / 8)
  static constexpr int TWK = TW + K - 1;       // columns the tile's outputs read
  static constexpr int SW = TW + 8 * (S - 1);  // staged columns; those >= TWK are zero
  static constexpr int LD = SW + (40 - SW % 32) % 32;  // floats a plane row: 8 mod 32
  static constexpr int SH = TH + K - 1;        // staged rows
  static constexpr int PLANE = SH * LD + (42 - SH * LD % 32) % 32;  // plane stride: 10 mod 32
  static constexpr int NE = 8 * S + 8;         // (hi, lo) tap entries a kernel row
  static constexpr size_t SMEM = sizeof(float) * (2 * K * NE + CP * PLANE);
  static_assert(LD % 32 == 8, "8-byte A reads of rows g .. g + 3 take other banks");
  static_assert(SMEM <= 232448, "above a block's shared memory");
};

// index i of an axis of n, reflected as numpy's mode="reflect" pads: the
// fold is periodic with period 2(n - 1), so any i lands in 0..n-1. FOLDED:
// the caller knows that -(n - 1) <= i <= 2(n - 1), where one fold is exact.
template <bool FOLDED>
__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  if (FOLDED) return i >= n ? 2 * (n - 1) - i : i;
  if (n == 1) return 0;
  const int p = 2 * (n - 1);
  i %= p;
  return i >= n ? p - i : i;
}

// true when every index lo..hi of an axis of n lies within one fold
__device__ __forceinline__ bool within_one_fold(int lo, int hi, int n) {
  return lo >= -(n - 1) && hi <= 2 * (n - 1);
}

// stage the tile's rows r and columns q (q < TWK; zero beyond) of channels
// c0 .. c0 + cc - 1 into the CP planes: one thread loads a pixel's
// channels, adjacent threads adjacent pixels
template <int K, bool FOLDED>
__device__ __forceinline__ void stage_tile(const float* __restrict__ img, float* s_in, int ty0, int gx0,
                                           int h, int w, int c, int c0, int cc, int tid) {
  using Gm = Geom<K>;
  constexpr int PAD = Gm::PAD, SW = Gm::SW, TWK = Gm::TWK, SH = Gm::SH, LD = Gm::LD, PLANE = Gm::PLANE;
  for (int i0 = tid; i0 < SH * SW; i0 += THREADS * UNROLL) {
    float v[UNROLL][CP];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS, r = i / SW, q = i % SW;
      const bool ok = i < SH * SW && q < TWK;
      const float* src = img + ((size_t)reflect101<FOLDED>(ty0 - PAD + r, h) * w +
                                reflect101<FOLDED>(gx0 + q, w)) * c + c0;
#pragma unroll
      for (int p = 0; p < CP; ++p) v[u][p] = ok && p < cc ? __ldg(src + p) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS, r = i / SW, q = i % SW;
      if (i >= SH * SW) break;
#pragma unroll
      for (int p = 0; p < CP; ++p)
        if (p < cc) s_in[p * PLANE + r * LD + q] = v[u][p];
    }
  }
}

// x rounded to TF32 (10 explicit mantissa bits) to nearest, ties away from
// zero, as cvt.rna.tf32.f32 does for finite x (csrc/rdb.cu's rounding)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x ~ hi + lo, both TF32, |x - hi - lo| <= 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c (16x8 f32) += a (16x8 tf32, row) * b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b, the first product of a fresh accumulator
__device__ __forceinline__ void mma_tf32_first(float* d, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

template <int K>
__global__ void __launch_bounds__(THREADS, 2)
filter2d_tf32_kernel(const float* __restrict__ images, const float* __restrict__ kernels,
                     float* __restrict__ out, int h, int w, int c, int tiles_x) {
  using Gm = Geom<K>;
  constexpr int PAD = Gm::PAD, S = Gm::S, TWK = Gm::TWK, LD = Gm::LD;
  constexpr int SH = Gm::SH, PLANE = Gm::PLANE, NE = Gm::NE;
  extern __shared__ __align__(16) float smem[];
  float2* s_tap = reinterpret_cast<float2*>(smem);  // K x NE (hi, lo)
  float* s_in = smem + 2 * K * NE;                  // CP planes of SH x LD, PLANE apart

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cp = warp % CP, y0 = 16 * (warp / CP);
  const int n = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TH, tx0 = (blockIdx.x % tiles_x) * TW;
  const int gx0 = tx0 - PAD;  // image column of staged column 0
  const float* img = images + (size_t)n * h * w * c;

  // the sample's taps split once: entry e of row dy holds k[dy, e - 8]
  // (zero outside 0..K-1)
  const float* kn = kernels + (size_t)n * K * K;
  for (int i = tid; i < K * NE; i += THREADS) {
    const int dy = i / NE, d = i % NE - 8;
    uint32_t hi, lo;
    split_tf32(d >= 0 && d < K ? kn[dy * K + d] : 0.f, hi, lo);
    s_tap[i] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
  }
  const bool folded = within_one_fold(ty0 - PAD, ty0 - PAD + SH - 1, h) &&
                      within_one_fold(gx0, gx0 + TWK - 1, w);

  for (int c0 = 0; c0 < c; c0 += CP) {
    const int cc = min(CP, c - c0);
    __syncthreads();  // the taps are written; the previous pass is done with s_in
    if (folded) {
      stage_tile<K, true>(img, s_in, ty0, gx0, h, w, c, c0, cc, tid);
    } else {
      stage_tile<K, false>(img, s_in, ty0, gx0, h, w, c, c0, cc, tid);
    }
    __syncthreads();
    if (cp >= cc || ty0 + y0 >= h) continue;

    float acc[G][4];
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[gi][i] = 0.f;
    const float* plane = s_in + cp * PLANE + (y0 + g) * LD + 2 * t;
#pragma unroll 1
    for (int dy = 0; dy < K; ++dy) {
      // a kernel row of zero taps adds nothing (on finite input): the
      // chain's kernels of 7..25 zero-padded to 25 have 57% of rows nonzero
      const float2 tap = s_tap[dy * NE + 8 + (lane < K ? lane : 0)];
      if (!__any_sync(0xffffffffu, lane < K && (tap.x != 0.f || tap.y != 0.f))) continue;
      // B fragments of kernel row dy, k-step s: b0 = k[dy, 8s + 2t - g],
      // b1 = k[dy, 8s + 2t + 1 - g], hi and lo
      uint32_t bh[S][2], bl[S][2];
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 b = s_tap[dy * NE + 8 * s + 2 * t + j - g + 8];
          bh[s][j] = __float_as_uint(b.x), bl[s][j] = __float_as_uint(b.y);
        }
      }
      const float* rows = plane + dy * LD;
      float part[G][4];
#pragma unroll
      for (int f = 0; f < G + S - 1; ++f) {
        // A fragment f: columns 8f + 2t, 8f + 2t + 1 of rows g, g + 8,
        // split into TF32 halves
        const float2 a = *reinterpret_cast<const float2*>(rows + 8 * f);
        const float2 d = *reinterpret_cast<const float2*>(rows + 8 * LD + 8 * f);
        uint32_t ah[4], al[4];
        split_tf32(a.x, ah[0], al[0]);
        split_tf32(d.x, ah[1], al[1]);
        split_tf32(a.y, ah[2], al[2]);
        split_tf32(d.y, ah[3], al[3]);
        // group gi = f - s at k-step s; a warp issues in order, so one
        // product goes to each of the (up to S) groups before the next
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int gi = f - s;
          if (gi < 0 || gi >= G) continue;
          if (s == 0) {
            mma_tf32_first(part[gi], al, bh[s][0], bh[s][1]);
          } else {
            mma_tf32(part[gi], al, bh[s][0], bh[s][1]);
          }
        }
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int gi = f - s;
          if (gi >= 0 && gi < G) mma_tf32(part[gi], ah, bl[s][0], bl[s][1]);
        }
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int gi = f - s;
          if (gi >= 0 && gi < G) mma_tf32(part[gi], ah, bh[s][0], bh[s][1]);
        }
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[gi][i] += part[gi][i];
    }

    // c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gy = ty0 + y0 + g + 8 * half;
      if (gy >= h) continue;
      float* dst = out + ((size_t)n * h + gy) * w * c + c0 + cp;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int gx = tx0 + 8 * gi + 2 * t;
        if (gx < w) dst[(size_t)gx * c] = acc[gi][2 * half];
        if (gx + 1 < w) dst[(size_t)(gx + 1) * c] = acc[gi][2 * half + 1];
      }
    }
  }
}

template <int K>
int launch(const float* images, const float* kernels, float* out, int n, int h, int w, int c,
           cudaStream_t stream) {
  const int tiles_x = (w + TW - 1) / TW;
  const int tiles_y = (h + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, n);
  const cudaError_t err = cudaFuncSetAttribute(
      filter2d_tf32_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Geom<K>::SMEM);
  if (err != cudaSuccess) return (int)err;
  filter2d_tf32_kernel<K><<<grid, THREADS, Geom<K>::SMEM, stream>>>(images, kernels, out, h, w, c,
                                                                     tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point. Returns 0, the cudaGetLastError() code of a failed
// launch, or -1 for arguments the kernel does not take (K even or above
// KMAX, empty or oversized grids). Launches on `stream`; does not
// synchronise.
extern "C" int filter2d_cuda(const float* images, const float* kernels, float* out, int n, int h,
                             int w, int c, int k, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || k <= 0 || k % 2 == 0 || k > KMAX) return -1;
  if (n > 65535) return -1;
  if ((long long)((w + TW - 1) / TW) * ((h + TH - 1) / TH) > 0x7fffffffLL) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(images, kernels, out, n, h, w, c, s);
    case 3: return launch<3>(images, kernels, out, n, h, w, c, s);
    case 5: return launch<5>(images, kernels, out, n, h, w, c, s);
    case 7: return launch<7>(images, kernels, out, n, h, w, c, s);
    case 9: return launch<9>(images, kernels, out, n, h, w, c, s);
    case 11: return launch<11>(images, kernels, out, n, h, w, c, s);
    case 13: return launch<13>(images, kernels, out, n, h, w, c, s);
    case 15: return launch<15>(images, kernels, out, n, h, w, c, s);
    case 17: return launch<17>(images, kernels, out, n, h, w, c, s);
    case 19: return launch<19>(images, kernels, out, n, h, w, c, s);
    case 21: return launch<21>(images, kernels, out, n, h, w, c, s);
    case 23: return launch<23>(images, kernels, out, n, h, w, c, s);
    case 25: return launch<25>(images, kernels, out, n, h, w, c, s);
    case 27: return launch<27>(images, kernels, out, n, h, w, c, s);
    case 29: return launch<29>(images, kernels, out, n, h, w, c, s);
    case 31: return launch<31>(images, kernels, out, n, h, w, c, s);
  }
  return -1;
}

extern "C" const char* filter2d_error_string(int code) {
  return code < 0 ? "argument not supported by the kernel"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
