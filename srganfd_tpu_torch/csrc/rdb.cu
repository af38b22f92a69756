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
// Design (simple first): one direct-convolution kernel launched five times
// per block. The caller passes x (N, H, W, ch) and a scratch buffer feat
// (N, H, W, 4*gc), both channels-last; launch k reads the first ch + k*gc
// channels of the virtual concat [x | feat] and writes its gc outputs into
// feat[..., k*gc : (k+1)*gc], so the dense concatenation is never copied.
// Launch 5 reads all ch + 4*gc channels, adds the scaled residual and
// writes the output. A block owns a 16x16 output tile and 32 output
// channels; input channels are staged 8 at a time with a one-pixel halo in
// shared memory (as f32), weights likewise; each thread accumulates
// 4 pixels x 8 channels in registers on the CUDA cores. Any N, H, W work
// (the ragged tile edge is masked); ch and gc must be multiples of 8.
//
// Bound at the serving shape, x (1, 256, 256, 64) bf16, ch=64, gc=32:
// 9 * (64+96+128+160) * 32 + 9 * 192 * 64 = 239,616 MAC per pixel, so
// 2 * 65,536 * 239,616 = 3.14e10 FLOP per block: 31.7 us at the H100's
// 989 TFLOP/s bf16 tensor-core peak, against ~5 us for the ~17 MB that
// must move (x and the output once each, the weights) at 3.35 TB/s.
// Compute-bound; the trunk's 69 blocks bound a 256x256 frame at ~2.2 ms.
//
// What this design leaves on the table: it runs on the CUDA cores in f32
// (no mma.sync / wgmma), so it cannot pass ~67 TFLOP/s, and shared-memory
// loads, not FMAs, limit its inner loop. out_1..out_4 round-trip through
// device memory (L2) between launches, where the Pallas kernel keeps the
// dense concat on chip. Tensor cores, TMA staging and one fused launch per
// block are later work.

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

template <typename T>
int rdb_forward_t(const void* x, void* feat, const void* w, const float* bias, void* out,
                  int n, int h, int wd, int ch, int gc, cudaStream_t stream) {
  const int fc = 4 * gc;
  size_t woff = 0;
  int boff = 0;
  for (int k = 0; k < 5; ++k) {
    const int cin = ch + k * gc;
    const int cout = k < 4 ? gc : ch;
    const int co_tiles = (cout + CO_T - 1) / CO_T;
    const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, n * co_tiles);
    const T* wk = static_cast<const T*>(w) + woff;
    if (k < 4) {
      conv3x3_kernel<T, false><<<grid, THREADS, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(feat), wk, bias + boff,
          static_cast<T*>(feat), h, wd, ch, fc, cin, cout, k * gc, co_tiles);
    } else {
      conv3x3_kernel<T, true><<<grid, THREADS, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(feat), wk, bias + boff,
          static_cast<T*>(out), h, wd, ch, fc, cin, cout, 0, co_tiles);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    woff += (size_t)cin * 9 * cout;
    boff += cout;
  }
  return 0;
}

}  // namespace

// Plain C entry point. dtype: 0 = float32, 1 = bfloat16. Returns 0, the
// cudaGetLastError() code of the first failed launch, or -1 for arguments
// the kernel does not take. Launches on `stream`; does not synchronise.
extern "C" int rdb_forward_cuda(const void* x, void* feat, const void* w, const float* bias,
                                void* out, int n, int h, int wd, int ch, int gc, int dtype,
                                void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || ch <= 0 || gc <= 0 || ch % 8 || gc % 8) return -1;
  const int widest = ch > gc ? ch : gc;
  if ((h + TH - 1) / TH > 65535 || (long long)n * ((widest + CO_T - 1) / CO_T) > 65535) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return rdb_forward_t<float>(x, feat, w, bias, out, n, h, wd, ch, gc, s);
  if (dtype == 1) return rdb_forward_t<__nv_bfloat16>(x, feat, w, bias, out, n, h, wd, ch, gc, s);
  return -1;
}

extern "C" const char* rdb_error_string(int code) {
  return code < 0 ? "argument not supported by the kernel"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
