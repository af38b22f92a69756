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
// conv kernel is chosen by dtype, with no fallback between them:
//
// f32, `conv3x3_kernel<float, ...>` (the CUDA-core design): a block
// owns a 16x16 output tile and 32 output channels; input channels are
// staged 8 at a time with a one-pixel halo in shared memory, weights
// likewise; each thread accumulates 4 pixels x 8 channels in f32 FMAs.
//
// bf16, `conv3x3_mma_kernel` (tensor cores): each launch is an implicit
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
// (one fused launch), and there is no TMA. The f32 path stays on the CUDA
// cores (TF32 would not meet its 1e-4 check), where shared-memory loads,
// not FMAs, set its pace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 16;           // output tile rows
constexpr int TW = 16;           // output tile columns
constexpr int PX = 4;            // output columns per thread
constexpr int CO_T = 32;         // output channels per block
constexpr int CO_PER = 8;        // output channels per thread
constexpr int CK = 8;            // input channels per staged chunk
constexpr int IN_H = TH + 2;     // staged rows (one-pixel halo)
constexpr int IN_W = TW + 2;     // staged columns
constexpr int THREADS = (TH * TW / PX) * (CO_T / CO_PER);  // 256
constexpr int CO_VECS = CO_T / 8;                          // weight vectors per (ci, tap)

static_assert(CK == 8, "staging moves one 8-channel vector per pixel");
static_assert(THREADS == 256, "thread layout below assumes 256 threads");

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

// One 3x3 'same' conv of the virtual concat [x (ch) | feat (fc)] over its
// first `cin` channels, for output channels [co0, co0 + CO_T) of image n.
// w: packed [cin][9][cout] in T; bias: f32 [cout].
// LAST = false: out = feat, writes lrelu(conv + b) at channel offset out_off.
// LAST = true:  out (N, H, W, ch) = (conv + b) * 0.2 + x.
template <typename T, bool LAST>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* feat, const T* __restrict__ w,
               const float* __restrict__ bias, T* out, int h, int wd, int ch, int fc,
               int cin, int cout, int out_off, int co_tiles) {
  __shared__ float s_in[CK][IN_H][IN_W];
  __shared__ __align__(16) float s_w[CK][9][CO_T];

  const int tid = threadIdx.x;
  const int cg = tid & 3;             // output channels co0 + cg*8 .. +8
  const int pg = tid >> 2;            // pixel group 0..63
  const int row = pg >> 2;            // tile row 0..15
  const int col0 = (pg & 3) * PX;     // tile columns col0 .. col0+3
  const int tx0 = blockIdx.x * TW;
  const int ty0 = blockIdx.y * TH;
  const int n = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * CO_T;
  const size_t img = (size_t)n * h * wd;

  float acc[PX][CO_PER];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int o = 0; o < CO_PER; ++o) acc[p][o] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CK) {
    // ch % 8 == 0, so a chunk lies wholly in x or wholly in feat
    const T* src = c0 < ch ? x : feat;
    const int stride = c0 < ch ? ch : fc;
    const int cs = c0 < ch ? c0 : c0 - ch;
    for (int p = tid; p < IN_H * IN_W; p += THREADS) {
      const int r = p / IN_W, cc = p % IN_W;
      const int gy = ty0 - 1 + r, gx = tx0 - 1 + cc;
      float v[8];
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd) {
        load8(src + (img + (size_t)gy * wd + gx) * stride + cs, v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) s_in[i][r][cc] = v[i];
    }
    for (int e = tid; e < CK * 9 * CO_VECS; e += THREADS) {
      const int j = e % CO_VECS;
      const int t = e / CO_VECS;  // ci * 9 + tap
      const int co = co0 + j * 8;
      float v[8];
      if (co < cout) {
        load8(w + ((size_t)c0 * 9 + t) * cout + co, v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      }
      float* d = &s_w[0][0][0] + t * CO_T + j * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = v[i];
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float in[PX + 2];
#pragma unroll
        for (int i = 0; i < PX + 2; ++i) in[i] = s_in[ci][row + dy][col0 + i];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float wv[CO_PER];
          load8(&s_w[ci][dy * 3 + dx][cg * CO_PER], wv);
#pragma unroll
          for (int p = 0; p < PX; ++p)
#pragma unroll
            for (int o = 0; o < CO_PER; ++o) acc[p][o] = fmaf(in[p + dx], wv[o], acc[p][o]);
        }
      }
    }
    __syncthreads();
  }

  const int co = co0 + cg * CO_PER;
  const int gy = ty0 + row;
  if (co >= cout || gy >= h) return;
  float b[CO_PER];
#pragma unroll
  for (int o = 0; o < CO_PER; ++o) b[o] = bias[co + o];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int gx = tx0 + col0 + p;
    if (gx >= wd) continue;
    const size_t pix = img + (size_t)gy * wd + gx;
    float v[CO_PER];
    if (LAST) {
      float xr[CO_PER];
      load8(x + pix * ch + co, xr);
      // explicit roundings: no fused multiply-add, as in the reference
#pragma unroll
      for (int o = 0; o < CO_PER; ++o)
        v[o] = __fadd_rn(__fmul_rn(__fadd_rn(acc[p][o], b[o]), 0.2f), xr[o]);
      store8(out + pix * ch + co, v);
    } else {
#pragma unroll
      for (int o = 0; o < CO_PER; ++o) {
        const float y = __fadd_rn(acc[p][o], b[o]);
        v[o] = y >= 0.f ? y : __fmul_rn(0.2f, y);
      }
      store8(out + pix * fc + out_off + co, v);
    }
  }
}

// f32: five CUDA-core launches
int rdb_forward_f32(const float* x, float* feat, const float* w, const float* bias, float* out,
                    int n, int h, int wd, int ch, int gc, cudaStream_t stream) {
  const int fc = 4 * gc;
  size_t woff = 0;
  int boff = 0;
  for (int k = 0; k < 5; ++k) {
    const int cin = ch + k * gc;
    const int cout = k < 4 ? gc : ch;
    const int co_tiles = (cout + CO_T - 1) / CO_T;
    const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, n * co_tiles);
    if (k < 4) {
      conv3x3_kernel<float, false><<<grid, THREADS, 0, stream>>>(
          x, feat, w + woff, bias + boff, feat, h, wd, ch, fc, cin, cout, k * gc, co_tiles);
    } else {
      conv3x3_kernel<float, true><<<grid, THREADS, 0, stream>>>(
          x, feat, w + woff, bias + boff, out, h, wd, ch, fc, cin, cout, 0, co_tiles);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    woff += (size_t)cin * 9 * cout;
    boff += cout;
  }
  return 0;
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

}  // namespace

// Plain C entry point. dtype: 0 = float32 (CUDA cores; w packed
// [cin][9][cout]), 1 = bfloat16 (tensor cores; w packed
// [ceil(cin/16)][9][cout rounded up to 16][16], zero-padded). Returns 0, the
// cudaGetLastError() code of the first failed launch, or -1 for arguments
// the kernel does not take. Launches on `stream`; does not synchronise.
extern "C" int rdb_forward_cuda(const void* x, void* feat, const void* w, const float* bias,
                                void* out, int n, int h, int wd, int ch, int gc, int dtype,
                                void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || ch <= 0 || gc <= 0 || ch % 8 || gc % 8) return -1;
  const int widest = ch > gc ? ch : gc;
  // both kernels tile H by 16 rows; the f32 kernel's 32-wide cout tiles
  // give the larger grid.z
  if ((h + TH - 1) / TH > 65535 || (long long)n * ((widest + CO_T - 1) / CO_T) > 65535) return -1;
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
