// Residual Dense Block forward for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernels `rdb_forward_pallas` (srganfd_tpu/ops/pallas/rdb.py,
// body `_rdb_kernel`) and `rdb_forward_pallas_v2` (body `_rdb_v2_kernel`):
//
//   out_k = lrelu(conv_k(cat[x, out_1 .. out_{k-1}]) + b_k)   k = 1..4
//   y     = conv_5(cat[x, out_1 .. out_4]) + b_5
//   rdb   = y * 0.2 + x
//
// with 3x3 'same' zero-padded convs, the numerics of the Pallas kernels:
// operands (x, weights, out_k) in x's dtype (f32 or bf16), products summed
// in f32, bias and LeakyReLU(0.2) in f32, out_k rounded to x's dtype
// before it feeds the later convs, and `y * 0.2 + x` in f32, stored in
// x's dtype.
//
// Five launches per block, one 3x3 conv each. The caller passes x (N, H,
// W, ch) and a scratch buffer feat (N, H, W, 4*gc), both channels-last;
// launch k reads the first ch + k*gc channels of the virtual concat
// [x | feat] and writes its gc outputs into feat[..., k*gc : (k+1)*gc], so
// the dense concatenation is never copied. Launch 5 reads all ch + 4*gc
// channels, adds the scaled residual and writes the output. Any N, H, W
// work (ragged tiles are masked); ch and gc must be multiples of 8. The
// conv kernel is chosen by dtype, with no fallback between them; both run
// on the tensor cores with one tiling:
//
// bf16, `conv3x3_mma_kernel`: each launch is an implicit
// GEMM, M = the block's 16x8 output pixels, N = cout (a tile of 16, 32 or
// 64), K = 9 * cin. Per step the block stages 16 input channels of its
// 18x10 halo tile (channels-last, bf16, 16-byte cp.async, zero-filled
// outside the image and past cin with a cp.async src-size of 0) and the
// matching weights, packed by `pack_rdb_weights` as [cin/16][tap][cout][16],
// into double-buffered shared memory, so the next step loads while this
// one computes. Each of 4 warps owns 4 output rows x 8 columns (two m16
// tiles of 2 rows). For each tap (dy, dx) one ldmatrix.x4 per m-tile reads
// the A fragment from the shifted window of the halo tile (ldmatrix takes
// any 16-byte row address, so no im2col copy), one ldmatrix.x4 per 16
// output channels reads the B fragments, and mma.sync.m16n8k16 (bf16 in,
// f32 accumulate) runs per 8 output channels. Pixel and weight rows are
// XOR-swizzled so each 8x16-byte ldmatrix phase hits 32 distinct banks.
// The epilogue stages acc + bias in f32 through shared memory and writes
// 8 channels (16 bytes) per store: LeakyReLU(0.2), or `* 0.2 + x`, in f32,
// rounded to bf16 once. A 16-wide chunk that cin only half fills (cin = 24,
// 40, ...) is zero in both the staged input and the packed weights.
//
// f32, `conv3x3_tf32_kernel` (split-precision 3xTF32): the same implicit
// GEMM and warps (cout tiles of 16 or 32), over 8-channel steps of
// mma.sync.m16n8k8 (TF32 in, f32 accumulate). A staged pixel of 8 f32
// channels is 32 bytes, as a bf16 pixel of 16 channels is, so the halo
// tile, its swizzle and the ldmatrix lane roles carry over: an 8x8 b16
// matrix whose 16-byte rows hold 4 f32 channels lands in the TF32 A layout
// (row = lane / 4, column = lane % 4), and likewise for B. TF32 keeps 10
// mantissa bits, about 3 decimal digits, which misses the f32 check, so
// each operand is split into two TF32 values, a ~ hi + lo with hi =
// rna(a), lo = rna(a - hi) (|a - hi - lo| <= 2^-22 |a|), and a * b ~ a_lo
// b_hi + a_hi b_lo + a_hi b_hi, three mma per fragment pair; the dropped
// a_lo b_lo is ~2^-22 relative. Each thread splits the input values it
// staged once, in shared memory (hi in place, lo beside it), so a tap reads
// both halves with ldmatrix; `pack_rdb_weights` splits the weights
// beforehand, [cin/8][hi, lo][tap][cout][8] (cout zero-padded to 16). The
// tensor cores' f32 accumulation does not round to nearest, so its error
// grows with the mma count and the size of the register summed into: each
// 8-channel step's products go into a fresh register, added to the total in
// f32 after the step. The epilogue is the bf16 kernel's, storing f32.
//
// The numerics of the Pallas kernels in both: operands (x, weights, out_k)
// in x's dtype, exact products summed in f32, bias and LeakyReLU(0.2) in
// f32, out_k rounded to x's dtype before it feeds the later convs, and
// `y * 0.2 + x` in f32, stored in x's dtype.
//
// Bound at the serving shape, x (1, 256, 256, 64) bf16, ch=64, gc=32:
// 9 * (64+96+128+160) * 32 + 9 * 192 * 64 = 239,616 MAC per pixel, so
// 2 * 65,536 * 239,616 = 3.14e10 FLOP per block: 31.7 us at the H100's
// 989 TFLOP/s bf16 tensor-core peak, against ~5 us for the ~17 MB that
// must move (x and the output once each, the weights) at 3.35 TB/s.
// Compute-bound; the trunk's 69 blocks bound a 256x256 frame at ~2.2 ms.
//
// What the bf16 design leaves: mma.sync does not reach the tensor cores'
// full rate (wgmma does, but its shared-memory descriptors need uniformly
// strided core matrices, so the shifted windows would need an im2col
// copy); every block re-reads the conv's weights from L2 and the
// halo costs 1.4x the tile's pixels; out_1..out_4 round-trip through L2
// between launches, where the Pallas kernel keeps the dense concat on chip
// (one fused launch), and there is no TMA.
//
// f32: three TF32 products per pair, 3 * 3.14e10 FLOP, 190 us at the
// H100's 495 TFLOP/s dense TF32 peak (469 us for one product each at the
// CUDA cores' 67 TFLOP/s f32 peak). Per 8-channel step a block stages its
// hi and lo weights, 4x the bf16 kernel's weight bytes per channel, so the
// weights' L2 traffic weighs more than in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// ---- bf16: tensor cores -------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int KC = 16;                 // input channels per staged step (one mma k-step)
constexpr int M_WARPS = 4;
constexpr int M_THREADS = 32 * M_WARPS;
constexpr int M_TW = 8;                // output tile columns: one ldmatrix row of pixels
constexpr int M_TH = 4 * M_WARPS;      // output tile rows: 4 per warp
constexpr int M_SW = M_TW + 2;         // staged columns (one-pixel halo)
constexpr int M_PIX = (M_TH + 2) * M_SW;
constexpr int M_IN_UNITS = M_PIX * 2;  // 16-byte units of one staged input step

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src
// must still be a mapped address; it is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Unit `half` (channels 0-7 or 8-15) of row r (a staged pixel, or a
// (tap, cout) weight row) of 32 bytes: XOR-swizzled so that 8 consecutive
// rows at one half fall into 8 distinct 16-byte bank groups.
__device__ __forceinline__ int unit2(int r, int half) { return r * 2 + (half ^ ((r >> 2) & 1)); }

template <int COUT>
constexpr int mma_smem_bytes() {
  // two staged steps of input and weights; the epilogue's f32 tile reuses them
  return 16 * 2 * (M_IN_UNITS + 9 * COUT * 2) > 4 * M_TH * M_TW * (COUT + 8)
             ? 16 * 2 * (M_IN_UNITS + 9 * COUT * 2)
             : 4 * M_TH * M_TW * (COUT + 8);
}

// One 3x3 'same' conv of the virtual concat [x (ch) | feat (fc)] over its
// first `cin` channels, output channels [co0, co0 + COUT) of image n.
// w: packed [ceil(cin/16)][9][cout_pad][16] bf16 (cout_pad = cout rounded
// up to 16, zero-padded); bias: f32 [cout].
// LAST = false: out = feat, writes lrelu(conv + b) at channel offset out_off.
// LAST = true:  out (N, H, W, ch) = (conv + b) * 0.2 + x.
template <int COUT, bool LAST>
__global__ void __launch_bounds__(M_THREADS)
conv3x3_mma_kernel(const bf16* __restrict__ x, const bf16* feat, const bf16* __restrict__ w,
                   const float* __restrict__ bias, bf16* out, int h, int wd, int ch, int fc,
                   int cin, int cout, int out_off, int co_tiles) {
  extern __shared__ __align__(128) uint4 smem[];
  constexpr int W_UNITS = 9 * COUT * 2;
  const int cout_pad = (cout + 15) & ~15;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tx0 = blockIdx.x * M_TW;
  const int ty0 = blockIdx.y * M_TH;
  const int n = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * COUT;
  const size_t img = (size_t)n * h * wd;

  auto stage = [&](int buf, int c0) {
    uint4* s_in = smem + buf * M_IN_UNITS;
    for (int e = tid; e < M_IN_UNITS; e += M_THREADS) {
      const int p = e >> 1, half = e & 1;
      const int gy = ty0 - 1 + p / M_SW, gx = tx0 - 1 + p % M_SW;
      const int c = c0 + half * 8;  // ch % 8 == 0: 8 channels lie wholly in x or in feat
      const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < wd && c < cin;
      const bf16* src = x;
      if (ok) {
        const size_t pix = img + (size_t)gy * wd + gx;
        src = c < ch ? x + pix * ch + c : feat + pix * fc + (c - ch);
      }
      cp_async16(smem_u32(s_in + unit2(p, half)), src, ok);
    }
    uint4* s_w = smem + 2 * M_IN_UNITS + buf * W_UNITS;
    const bf16* wc = w + (size_t)(c0 / KC) * 9 * cout_pad * KC;
    for (int e = tid; e < W_UNITS; e += M_THREADS) {
      const int row = e >> 1, half = e & 1;  // row = tap * COUT + co
      const int tap = row / COUT, co = co0 + row % COUT;
      const bool ok = co < cout_pad;
      cp_async16(smem_u32(s_w + unit2(row, half)),
                 ok ? wc + ((size_t)tap * cout_pad + co) * KC + half * 8 : wc, ok);
    }
    cp_async_commit();
  };

  float acc[2][COUT / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < COUT / 8; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][t][i] = 0.f;

  // ldmatrix lane roles. A (16 pixels x 16 channels): lanes 0-7 pixels of
  // the m-tile's first row, 8-15 of its second, channels 0-7; lanes 16-31
  // the same at channels 8-15. B (16 channels x 16 couts): lanes 0-7 couts
  // +0..7 channels 0-7, 8-15 couts +0..7 channels 8-15, 16-31 couts +8..15.
  int a_pix[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) a_pix[mt] = (warp * 4 + mt * 2 + ((lane >> 3) & 1)) * M_SW + (lane & 7);
  const int a_half = lane >> 4;
  const int b_row = ((lane >> 4) << 3) + (lane & 7), b_half = (lane >> 3) & 1;

  const int steps = (cin + KC - 1) / KC;
  stage(0, 0);
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) {
      stage((i + 1) & 1, (i + 1) * KC);
    } else {
      cp_async_commit();  // an empty group keeps the wait below uniform
    }
    cp_async_wait1();
    __syncthreads();
    const uint4* s_in = smem + (i & 1) * M_IN_UNITS;
    const uint4* s_w = smem + 2 * M_IN_UNITS + (i & 1) * W_UNITS;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * M_SW + tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(smem_u32(s_in + unit2(a_pix[mt] + shift, a_half)), a[mt]);
#pragma unroll
      for (int np = 0; np < COUT / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(smem_u32(s_w + unit2(tap * COUT + np * 16 + b_row, b_half)), b);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: acc + bias in f32 into a [pixel][COUT + 8] tile (the padding
  // keeps a half-warp's float2 stores on distinct banks), then 8 channels
  // (16 bytes) per store
  constexpr int OS = COUT + 8;
  float* s_out = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < COUT / 8; ++t) {
      const int co = t * 8 + tig * 2;
      const float b0 = co0 + co < cout ? bias[co0 + co] : 0.f;
      const float b1 = co0 + co + 1 < cout ? bias[co0 + co + 1] : 0.f;
      const int px = (warp * 4 + mt * 2) * M_TW + g;  // second row: px + M_TW
      *reinterpret_cast<float2*>(s_out + px * OS + co) =
          make_float2(__fadd_rn(acc[mt][t][0], b0), __fadd_rn(acc[mt][t][1], b1));
      *reinterpret_cast<float2*>(s_out + (px + M_TW) * OS + co) =
          make_float2(__fadd_rn(acc[mt][t][2], b0), __fadd_rn(acc[mt][t][3], b1));
    }
  __syncthreads();
  for (int e = tid; e < M_TH * M_TW * (COUT / 8); e += M_THREADS) {
    const int px = e / (COUT / 8), cg = e % (COUT / 8);
    const int gy = ty0 + px / M_TW, gx = tx0 + px % M_TW;
    const int co = co0 + cg * 8;
    if (gy >= h || gx >= wd || co >= cout) continue;
    const float4 lo = *reinterpret_cast<const float4*>(s_out + px * OS + cg * 8);
    const float4 hi = *reinterpret_cast<const float4*>(s_out + px * OS + cg * 8 + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const size_t pix = img + (size_t)gy * wd + gx;
    if (LAST) {
      float xr[8];
      load8(x + pix * ch + co, xr);
      // explicit roundings: no fused multiply-add, as in the reference
#pragma unroll
      for (int o = 0; o < 8; ++o) v[o] = __fadd_rn(__fmul_rn(v[o], 0.2f), xr[o]);
      store8(out + pix * ch + co, v);
    } else {
#pragma unroll
      for (int o = 0; o < 8; ++o) v[o] = v[o] >= 0.f ? v[o] : __fmul_rn(0.2f, v[o]);
      store8(out + pix * fc + out_off + co, v);
    }
  }
}

template <int COUT, bool LAST>
cudaError_t launch_mma(dim3 grid, cudaStream_t stream, const bf16* x, const bf16* feat,
                       const bf16* w, const float* bias, bf16* out, int h, int wd, int ch, int fc,
                       int cin, int cout, int out_off, int co_tiles) {
  constexpr int bytes = mma_smem_bytes<COUT>();
  static_assert(bytes <= 48 * 1024, "above 48 KB needs cudaFuncAttributeMaxDynamicSharedMemorySize");
  conv3x3_mma_kernel<COUT, LAST><<<grid, M_THREADS, bytes, stream>>>(
      x, feat, w, bias, out, h, wd, ch, fc, cin, cout, out_off, co_tiles);
  return cudaGetLastError();
}

// the cout tile of one launch: 16, 32 or 64 (wider couts take several tiles)
int cout_tile(int cout) { return cout <= 16 ? 16 : cout <= 32 ? 32 : 64; }

template <bool LAST>
cudaError_t launch_mma_any(int cout, dim3 grid, cudaStream_t stream, const bf16* x,
                           const bf16* feat, const bf16* w, const float* bias, bf16* out, int h,
                           int wd, int ch, int fc, int cin, int out_off, int co_tiles) {
  switch (cout_tile(cout)) {
    case 16:
      return launch_mma<16, LAST>(grid, stream, x, feat, w, bias, out, h, wd, ch, fc, cin, cout,
                                  out_off, co_tiles);
    case 32:
      return launch_mma<32, LAST>(grid, stream, x, feat, w, bias, out, h, wd, ch, fc, cin, cout,
                                  out_off, co_tiles);
    default:
      return launch_mma<64, LAST>(grid, stream, x, feat, w, bias, out, h, wd, ch, fc, cin, cout,
                                  out_off, co_tiles);
  }
}

// bf16: five tensor-core launches
int rdb_forward_bf16(const bf16* x, bf16* feat, const bf16* w, const float* bias, bf16* out,
                     int n, int h, int wd, int ch, int gc, cudaStream_t stream) {
  const int fc = 4 * gc;
  size_t woff = 0;
  int boff = 0;
  for (int k = 0; k < 5; ++k) {
    const int cin = ch + k * gc;
    const int cout = k < 4 ? gc : ch;
    const int tile = cout_tile(cout);
    const int co_tiles = (cout + tile - 1) / tile;
    const dim3 grid((wd + M_TW - 1) / M_TW, (h + M_TH - 1) / M_TH, n * co_tiles);
    const cudaError_t err =
        k < 4 ? launch_mma_any<false>(cout, grid, stream, x, feat, w + woff, bias + boff, feat, h,
                                      wd, ch, fc, cin, k * gc, co_tiles)
              : launch_mma_any<true>(cout, grid, stream, x, feat, w + woff, bias + boff, out, h,
                                     wd, ch, fc, cin, 0, co_tiles);
    if (err != cudaSuccess) return (int)err;
    woff += (size_t)((cin + KC - 1) / KC) * 9 * ((cout + 15) & ~15) * KC;
    boff += cout;
  }
  return 0;
}

// ---- f32: tensor cores, split-precision 3xTF32 --------------------------

constexpr int TK = 8;                 // input channels per staged step (one m16n8k8 k-step)
constexpr int T_WARPS = 4;
constexpr int T_THREADS = 32 * T_WARPS;
constexpr int T_TH = 4 * T_WARPS;     // output tile rows: 4 per warp (columns: M_TW)
constexpr int T_IN_UNITS = (T_TH + 2) * M_SW * 2;  // 16-byte units of one staged input step

// x rounded to TF32 (10 explicit mantissa bits) to nearest, ties away from
// zero, as cvt.rna.tf32.f32 does for finite x: the low 13 bits are zero.
// Integer operations, so that the CPU tests replay it bit for bit.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x ~ hi + lo, both TF32, |x - hi - lo| <= 2^-22 |x| (x - hi is exact)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c (16x8 f32) += a (16x8 tf32, row) * b (8x8 tf32, col)
// (not volatile: a pure function of its registers, free to be scheduled)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the f32 kernel's cout tile: 16 or 32 (wider couts take several tiles)
int tf32_cout_tile(int cout) { return cout <= 16 ? 16 : 32; }

// 16-byte units of one staged step: input hi, input lo, weights hi, weights lo
template <int COUT>
__host__ __device__ constexpr int tf32_stage_units() {
  return 2 * T_IN_UNITS + 2 * 9 * COUT * 2;
}

template <int COUT>
constexpr int tf32_smem_bytes() {
  // two staged steps; the epilogue's f32 tile reuses them
  return 16 * 2 * tf32_stage_units<COUT>() > 4 * T_TH * M_TW * (COUT + 8)
             ? 16 * 2 * tf32_stage_units<COUT>()
             : 4 * T_TH * M_TW * (COUT + 8);
}

// The f32 conv of `conv3x3_mma_kernel`'s arguments and warp layout (each
// warp 4 output rows x 8 columns). w: packed [cin/8][2][9][cout_pad][8] f32
// (hi, then lo; cout_pad = cout rounded up to 16, zero-padded).
template <int COUT, bool LAST>
__global__ void __launch_bounds__(T_THREADS)
conv3x3_tf32_kernel(const float* __restrict__ x, const float* feat, const float* __restrict__ w,
                    const float* __restrict__ bias, float* out, int h, int wd, int ch, int fc,
                    int cin, int cout, int out_off, int co_tiles) {
  extern __shared__ __align__(128) uint4 smem[];
  constexpr int W_UNITS = 9 * COUT * 2;  // one of hi, lo: (tap, cout) rows of 32 bytes
  constexpr int STAGE = tf32_stage_units<COUT>();
  const int cout_pad = (cout + 15) & ~15;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tx0 = blockIdx.x * M_TW;
  const int ty0 = blockIdx.y * T_TH;
  const int n = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * COUT;
  const size_t img = (size_t)n * h * wd;

  // stage layout: [input hi | input lo | weights hi | weights lo]
  auto stage = [&](int buf, int c0) {
    uint4* s_in = smem + buf * STAGE;
    for (int e = tid; e < T_IN_UNITS; e += T_THREADS) {
      const int p = e >> 1, half = e & 1;
      const int gy = ty0 - 1 + p / M_SW, gx = tx0 - 1 + p % M_SW;
      const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < wd;
      const float* src = x;
      if (ok) {
        // ch % 8 == 0: a step's 8 channels lie wholly in x or in feat
        const size_t pix = img + (size_t)gy * wd + gx;
        src = (c0 < ch ? x + pix * ch + c0 : feat + pix * fc + (c0 - ch)) + half * 4;
      }
      cp_async16(smem_u32(s_in + unit2(p, half)), src, ok);
    }
    uint4* s_w = s_in + 2 * T_IN_UNITS;
    const float* wc = w + (size_t)(c0 / TK) * 2 * 9 * cout_pad * TK;
    for (int e = tid; e < 2 * W_UNITS; e += T_THREADS) {
      const int part = e / W_UNITS, r = e % W_UNITS;  // part: 0 hi, 1 lo
      const int row = r >> 1, half = r & 1;           // row = tap * COUT + co
      const int tap = row / COUT, co = co0 + row % COUT;
      const bool ok = co < cout_pad;
      cp_async16(smem_u32(s_w + part * W_UNITS + unit2(row, half)),
                 ok ? wc + (((size_t)part * 9 + tap) * cout_pad + co) * TK + half * 4 : wc, ok);
    }
    cp_async_commit();
  };

  // Two accumulators per fragment: the tensor cores' f32 accumulation
  // does not round to nearest, and its error grows with the number of mma
  // into one register and with that register's size. So a step's products
  // go into `part`, added to `acc` in f32 (to nearest) after each step.
  float acc[2][COUT / 8][4], part[2][COUT / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < COUT / 8; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][t][i] = part[mt][t][i] = 0.f;

  // ldmatrix lane roles, as in the bf16 kernel with a 16-byte unit holding
  // 4 f32 channels. A (16 pixels x 8 channels): matrices 0-3 are (first
  // row, channels 0-3), (second row, 0-3), (first row, 4-7), (second row,
  // 4-7), the TF32 A registers a0-a3. B: (couts +0..7, channels 0-3 / 4-7),
  // then couts +8..15: b0, b1 of two n-tiles.
  int a_pix[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) a_pix[mt] = (warp * 4 + mt * 2 + ((lane >> 3) & 1)) * M_SW + (lane & 7);
  const int a_half = lane >> 4;
  const int b_row = ((lane >> 4) << 3) + (lane & 7), b_half = (lane >> 3) & 1;

  const int steps = cin / TK;
  stage(0, 0);
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) {
      stage((i + 1) & 1, (i + 1) * TK);
    } else {
      cp_async_commit();  // an empty group keeps the wait below uniform
    }
    cp_async_wait1();
    asm volatile("" ::: "memory");  // the plain loads below stay after the wait
    // this thread's own copies of step i have landed (the wait covers the
    // thread's own groups): split them into TF32 hi (in place) and lo, once
    // per staged value rather than once per tap
    uint4* s_in = smem + (i & 1) * STAGE;
    for (int e = tid; e < T_IN_UNITS; e += T_THREADS) {
      const int u = unit2(e >> 1, e & 1);
      const uint4 v = s_in[u];
      uint4 hi, lo;
      split_tf32(__uint_as_float(v.x), hi.x, lo.x);
      split_tf32(__uint_as_float(v.y), hi.y, lo.y);
      split_tf32(__uint_as_float(v.z), hi.z, lo.z);
      split_tf32(__uint_as_float(v.w), hi.w, lo.w);
      s_in[u] = hi;
      s_in[T_IN_UNITS + u] = lo;
    }
    __syncthreads();
    const uint4* s_wh = s_in + 2 * T_IN_UNITS;
    const uint4* s_wl = s_wh + W_UNITS;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * M_SW + tap % 3;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int a_unit = unit2(a_pix[mt] + shift, a_half);
        ldmatrix_x4(smem_u32(s_in + a_unit), ah[mt]);
        ldmatrix_x4(smem_u32(s_in + T_IN_UNITS + a_unit), al[mt]);
      }
#pragma unroll
      for (int np = 0; np < COUT / 16; ++np) {
        uint32_t bh[4], bl[4];
        const int w_unit = unit2(tap * COUT + np * 16 + b_row, b_half);
        ldmatrix_x4(smem_u32(s_wh + w_unit), bh);
        ldmatrix_x4(smem_u32(s_wl + w_unit), bl);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            // the two small cross terms first, then hi * hi, the large one
            float* c = part[mt][2 * np + j];
            mma_tf32(c, al[mt], bh[2 * j], bh[2 * j + 1]);
            mma_tf32(c, ah[mt], bl[2 * j], bl[2 * j + 1]);
            mma_tf32(c, ah[mt], bh[2 * j], bh[2 * j + 1]);
          }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int t = 0; t < COUT / 8; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[mt][t][j] += part[mt][t][j];
          part[mt][t][j] = 0.f;
        }
    __syncthreads();
  }

  // epilogue: the bf16 kernel's, storing f32
  constexpr int OS = COUT + 8;
  float* s_out = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < COUT / 8; ++t) {
      const int co = t * 8 + tig * 2;
      const float b0 = co0 + co < cout ? bias[co0 + co] : 0.f;
      const float b1 = co0 + co + 1 < cout ? bias[co0 + co + 1] : 0.f;
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = __fadd_rn(acc[mt][t][j], j & 1 ? b1 : b0);
      const int px = (warp * 4 + mt * 2) * M_TW + g;  // second row: px + M_TW
      *reinterpret_cast<float2*>(s_out + px * OS + co) = make_float2(y[0], y[1]);
      *reinterpret_cast<float2*>(s_out + (px + M_TW) * OS + co) = make_float2(y[2], y[3]);
    }
  __syncthreads();
  for (int e = tid; e < T_TH * M_TW * (COUT / 8); e += T_THREADS) {
    const int px = e / (COUT / 8), cg = e % (COUT / 8);
    const int gy = ty0 + px / M_TW, gx = tx0 + px % M_TW;
    const int co = co0 + cg * 8;
    if (gy >= h || gx >= wd || co >= cout) continue;
    float v[8];
    load8(s_out + px * OS + cg * 8, v);
    const size_t pix = img + (size_t)gy * wd + gx;
    if (LAST) {
      float xr[8];
      load8(x + pix * ch + co, xr);
      // explicit roundings: no fused multiply-add, as in the reference
#pragma unroll
      for (int o = 0; o < 8; ++o) v[o] = __fadd_rn(__fmul_rn(v[o], 0.2f), xr[o]);
      store8(out + pix * ch + co, v);
    } else {
#pragma unroll
      for (int o = 0; o < 8; ++o) v[o] = v[o] >= 0.f ? v[o] : __fmul_rn(0.2f, v[o]);
      store8(out + pix * fc + out_off + co, v);
    }
  }
}

template <int COUT, bool LAST>
cudaError_t launch_tf32(dim3 grid, cudaStream_t stream, const float* x, const float* feat,
                        const float* w, const float* bias, float* out, int h, int wd, int ch,
                        int fc, int cin, int cout, int out_off, int co_tiles) {
  constexpr int bytes = tf32_smem_bytes<COUT>();
  static_assert(bytes <= 227 * 1024, "above a block's shared memory");
  // above 48 KB only as opted-in dynamic shared memory; once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_tf32_kernel<COUT, LAST>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  conv3x3_tf32_kernel<COUT, LAST><<<grid, T_THREADS, bytes, stream>>>(
      x, feat, w, bias, out, h, wd, ch, fc, cin, cout, out_off, co_tiles);
  return cudaGetLastError();
}

template <bool LAST>
cudaError_t launch_tf32_any(int cout, dim3 grid, cudaStream_t stream, const float* x,
                            const float* feat, const float* w, const float* bias, float* out,
                            int h, int wd, int ch, int fc, int cin, int out_off, int co_tiles) {
  if (tf32_cout_tile(cout) == 16)
    return launch_tf32<16, LAST>(grid, stream, x, feat, w, bias, out, h, wd, ch, fc, cin, cout,
                                 out_off, co_tiles);
  return launch_tf32<32, LAST>(grid, stream, x, feat, w, bias, out, h, wd, ch, fc, cin, cout,
                               out_off, co_tiles);
}

// f32: five 3xTF32 tensor-core launches
int rdb_forward_f32(const float* x, float* feat, const float* w, const float* bias, float* out,
                    int n, int h, int wd, int ch, int gc, cudaStream_t stream) {
  const int fc = 4 * gc;
  size_t woff = 0;
  int boff = 0;
  for (int k = 0; k < 5; ++k) {
    const int cin = ch + k * gc;
    const int cout = k < 4 ? gc : ch;
    const int tile = tf32_cout_tile(cout);
    const int co_tiles = (cout + tile - 1) / tile;
    const dim3 grid((wd + M_TW - 1) / M_TW, (h + T_TH - 1) / T_TH, n * co_tiles);
    const cudaError_t err =
        k < 4 ? launch_tf32_any<false>(cout, grid, stream, x, feat, w + woff, bias + boff, feat, h,
                                       wd, ch, fc, cin, k * gc, co_tiles)
              : launch_tf32_any<true>(cout, grid, stream, x, feat, w + woff, bias + boff, out, h,
                                      wd, ch, fc, cin, 0, co_tiles);
    if (err != cudaSuccess) return (int)err;
    woff += (size_t)(cin / TK) * 2 * 9 * ((cout + 15) & ~15) * TK;
    boff += cout;
  }
  return 0;
}

}  // namespace

// Plain C entry point. dtype: 0 = float32 (3xTF32; w packed
// [cin/8][hi, lo][9][cout rounded up to 16][8], zero-padded), 1 = bfloat16
// (w packed [ceil(cin/16)][9][cout rounded up to 16][16], zero-padded); both
// on the tensor cores. Returns 0, the
// cudaGetLastError() code of the first failed launch, or -1 for arguments
// the kernel does not take. Launches on `stream`; does not synchronise.
extern "C" int rdb_forward_cuda(const void* x, void* feat, const void* w, const float* bias,
                                void* out, int n, int h, int wd, int ch, int gc, int dtype,
                                void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || ch <= 0 || gc <= 0 || ch % 8 || gc % 8) return -1;
  const int widest = ch > gc ? ch : gc;
  // both kernels tile H by 16 rows and cout by 16 to 64
  if ((h + M_TH - 1) / M_TH > 65535 || (long long)n * ((widest + 15) / 16) > 65535) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rdb_forward_f32(static_cast<const float*>(x), static_cast<float*>(feat),
                           static_cast<const float*>(w), bias, static_cast<float*>(out), n, h, wd,
                           ch, gc, s);
  if (dtype == 1)
    return rdb_forward_bf16(static_cast<const bf16*>(x), static_cast<bf16*>(feat),
                            static_cast<const bf16*>(w), bias, static_cast<bf16*>(out), n, h, wd,
                            ch, gc, s);
  return -1;
}

extern "C" const char* rdb_error_string(int code) {
  return code < 0 ? "argument not supported by the kernel"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
