// int8 3x3 'same' convolution for Hopper (sm_90a), bound through ctypes.
//
// Replaces no Pallas kernel: in the JAX package the int8 serving path
// (`--quant-int8`, srganfd_tpu/ops/quant.py `qconv2d`) is an XLA
// convolution with s8 operands and s32 sums. PyTorch's convolutions take
// no int8 tensors on CUDA, so the port's `qconv2d` runs here:
//
//   acc[n, y, x, co] = sum_{dy, dx, ci} xq[n, y + dy - 1, x + dx - 1, ci] * wq[dy, dx, ci, co]
//   out              = (float)acc * scale[co]        (or acc itself, as int32)
//
// with xq and wq int8, zero outside the image, the sum exact in int32
// (|acc| <= 127^2 * 9 * cin, below 2^31 for any cin the models use) and
// the one f32 rounding of the int32 -> f32 conversion (to nearest) and the
// multiply, as XLA's `convert` and `multiply` round them. The result equals
// the plain version bit for bit.
//
// The dataflow: an implicit GEMM, M = the block's 16x8 output pixels, N = a
// cout tile of 64, K = 9 * cin. Per step the block stages 32 input channels
// of its 18x10 halo tile (channels-last, 16-byte cp.async, zero-filled
// outside the image) and the matching weights, packed by `ops/cuda/qconv.py`
// as [cin/32][tap][cout_pad][32] int8 (cout_pad = cout rounded up to 16, zero
// padded), into double-buffered shared memory. A staged pixel of 32 int8
// channels is 32 bytes, as a bf16 pixel of 16 channels is, and the fragments
// of mma.sync.m16n8k32 (s8) hold the same bytes at the same lanes as those of
// m16n8k16 (bf16): A's a0..a3 are rows g and g + 8 at bytes 4 * (lane % 4)
// and 16 + 4 * (lane % 4), B's b0, b1 column g at the same bytes, C's c0..c3
// the same pixels and couts. So a bf16 m16n8k16 kernel's swizzled staging and
// ldmatrix lane roles serve unchanged, and only the mma (s8 x s8 -> s32) and
// the epilogue are the int8 path's own.
//
// Bound at the serving shape: a quantized RDB of x (1, 256, 256, 64) runs
// one conv per source (x: cin 64 -> 192 couts; out_1..out_4: cin 32 ->
// 160, 128, 96, 64), 2 * 65,536 * 9 * (64*192 + 32*(160+128+96+64)) =
// 3.14e10 operations, 15.9 us at the H100's 1,979 TOPS dense int8 rate.
// The bytes (int8 inputs, f32 outputs of 640 channels a pixel) take
// ~55 us at 3.35 TB/s, so with f32 outputs the convs are bound by bytes.
//
// What the design leaves: mma.sync does not reach the int8 tensor cores'
// full rate (wgmma does, over shared-memory descriptors that the shifted
// windows do not fit without an im2col copy), the f32 output is 4x the
// bytes of an int8 one, and the quantize pass before each conv
// (absmax, divide, round, clip) is plain PyTorch, not fused into the
// kernel (ROADMAP.md B5).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 32;                 // int8 input channels per staged step (one mma k-step)
constexpr int COUT = 64;               // output channels per block
constexpr int Q_WARPS = 4;
constexpr int Q_THREADS = 32 * Q_WARPS;
constexpr int Q_TW = 8;                // output tile columns
constexpr int Q_TH = 4 * Q_WARPS;      // output tile rows: 4 per warp
constexpr int Q_SW = Q_TW + 2;         // staged columns (one-pixel halo)
constexpr int Q_PIX = (Q_TH + 2) * Q_SW;
constexpr int Q_IN_UNITS = Q_PIX * 2;  // 16-byte units of one staged input step
constexpr int W_UNITS = 9 * COUT * 2;  // 16-byte units of one staged weight step
constexpr int OS = COUT + 8;           // epilogue tile row stride (32-bit words)

constexpr int smem_bytes() {
  return 16 * 2 * (Q_IN_UNITS + W_UNITS) > 4 * Q_TH * Q_TW * OS ? 16 * 2 * (Q_IN_UNITS + W_UNITS)
                                                                 : 4 * Q_TH * Q_TW * OS;
}

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

// c (16x8 s32) += a (16x32 s8, row) * b (32x8 s8, col)
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Unit `half` (channels 0-15 or 16-31) of row r (a staged pixel, or a
// (tap, cout) weight row) of 32 bytes: XOR-swizzled so that 8 consecutive
// rows at one half fall into 8 distinct 16-byte bank groups (rdb.cu's).
__device__ __forceinline__ int unit2(int r, int half) { return r * 2 + (half ^ ((r >> 2) & 1)); }

// x: (N, H, W, cin) int8; w: packed [cin/32][9][cout_pad][32] int8;
// scale: f32 [cout], or null for the int32 sums; out: (N, H, W, cout) f32
// or int32.
__global__ void __launch_bounds__(Q_THREADS)
qconv3x3_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, void* out, int h, int wd, int cin, int cout,
                   int co_tiles) {
  extern __shared__ __align__(128) uint4 smem[];
  const int cout_pad = (cout + 15) & ~15;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tx0 = blockIdx.x * Q_TW;
  const int ty0 = blockIdx.y * Q_TH;
  const int n = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * COUT;
  const size_t img = (size_t)n * h * wd;

  auto stage = [&](int buf, int c0) {
    uint4* s_in = smem + buf * Q_IN_UNITS;
    for (int e = tid; e < Q_IN_UNITS; e += Q_THREADS) {
      const int p = e >> 1, half = e & 1;
      const int gy = ty0 - 1 + p / Q_SW, gx = tx0 - 1 + p % Q_SW;
      const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < wd;
      const int8_t* src = ok ? x + (img + (size_t)gy * wd + gx) * cin + c0 + half * 16 : x;
      cp_async16(smem_u32(s_in + unit2(p, half)), src, ok);
    }
    uint4* s_w = smem + 2 * Q_IN_UNITS + buf * W_UNITS;
    const int8_t* wc = w + (size_t)(c0 / KC) * 9 * cout_pad * KC;
    for (int e = tid; e < W_UNITS; e += Q_THREADS) {
      const int row = e >> 1, half = e & 1;  // row = tap * COUT + co
      const int tap = row / COUT, co = co0 + row % COUT;
      const bool ok = co < cout_pad;
      cp_async16(smem_u32(s_w + unit2(row, half)),
                 ok ? wc + ((size_t)tap * cout_pad + co) * KC + half * 16 : wc, ok);
    }
    cp_async_commit();
  };

  int acc[2][COUT / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < COUT / 8; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][t][i] = 0;

  // ldmatrix lane roles, rdb.cu's with 16-byte units of 16 int8 channels.
  // A (16 pixels x 32 channels): lanes 0-7 pixels of the m-tile's first
  // row, 8-15 of its second, channels 0-15; lanes 16-31 the same at
  // channels 16-31. B (32 channels x 16 couts): lanes 0-7 couts +0..7
  // channels 0-15, 8-15 couts +0..7 channels 16-31, 16-31 couts +8..15.
  int a_pix[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) a_pix[mt] = (warp * 4 + mt * 2 + ((lane >> 3) & 1)) * Q_SW + (lane & 7);
  const int a_half = lane >> 4;
  const int b_row = ((lane >> 4) << 3) + (lane & 7), b_half = (lane >> 3) & 1;

  const int steps = cin / KC;
  stage(0, 0);
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) {
      stage((i + 1) & 1, (i + 1) * KC);
    } else {
      cp_async_commit();  // an empty group keeps the wait below uniform
    }
    cp_async_wait1();
    __syncthreads();
    const uint4* s_in = smem + (i & 1) * Q_IN_UNITS;
    const uint4* s_w = smem + 2 * Q_IN_UNITS + (i & 1) * W_UNITS;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * Q_SW + tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(smem_u32(s_in + unit2(a_pix[mt] + shift, a_half)), a[mt]);
#pragma unroll
      for (int np = 0; np < COUT / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(smem_u32(s_w + unit2(tap * COUT + np * 16 + b_row, b_half)), b);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_s8(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_s8(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: the 32-bit results (f32 (float)acc * scale, or acc) into a
  // [pixel][COUT + 8] tile, then 8 channels (32 bytes) per store
  uint32_t* s_out = reinterpret_cast<uint32_t*>(smem);
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < COUT / 8; ++t) {
      const int co = t * 8 + tig * 2;
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = co0 + co + (j & 1);
        if (scale != nullptr) {
          const float s = c < cout ? scale[c] : 0.f;
          v[j] = __float_as_uint(__fmul_rn(__int2float_rn(acc[mt][t][j]), s));
        } else {
          v[j] = static_cast<uint32_t>(acc[mt][t][j]);
        }
      }
      const int px = (warp * 4 + mt * 2) * Q_TW + g;  // second row: px + Q_TW
      *reinterpret_cast<uint2*>(s_out + px * OS + co) = make_uint2(v[0], v[1]);
      *reinterpret_cast<uint2*>(s_out + (px + Q_TW) * OS + co) = make_uint2(v[2], v[3]);
    }
  __syncthreads();
  uint32_t* o = static_cast<uint32_t*>(out);
  for (int e = tid; e < Q_TH * Q_TW * (COUT / 8); e += Q_THREADS) {
    const int px = e / (COUT / 8), cg = e % (COUT / 8);
    const int gy = ty0 + px / Q_TW, gx = tx0 + px % Q_TW;
    const int co = co0 + cg * 8;
    if (gy >= h || gx >= wd || co >= cout) continue;
    const uint4 lo = *reinterpret_cast<const uint4*>(s_out + px * OS + cg * 8);
    const uint4 hi = *reinterpret_cast<const uint4*>(s_out + px * OS + cg * 8 + 4);
    uint32_t* dst = o + (img + (size_t)gy * wd + gx) * cout + co;
    *reinterpret_cast<uint4*>(dst) = lo;
    *reinterpret_cast<uint4*>(dst + 4) = hi;
  }
}

}  // namespace

// Plain C entry point: one int8 3x3 'same' conv, launched on `stream`
// without synchronising. cin must be a multiple of 32 and cout of 8 (so
// that 8 output channels are one 32-byte store); `scale` null writes the
// int32 sums. Returns 0, the cudaGetLastError() code of a failed launch,
// or -1 for arguments the kernel does not take.
extern "C" int qconv3x3_s8_cuda(const void* x, const void* w, const float* scale, void* out, int n,
                                int h, int wd, int cin, int cout, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || cin % KC || cout % 8) return -1;
  const int co_tiles = (cout + COUT - 1) / COUT;
  if ((h + Q_TH - 1) / Q_TH > 65535 || (long long)n * co_tiles > 65535) return -1;
  constexpr int bytes = smem_bytes();
  static_assert(bytes <= 48 * 1024, "above 48 KB needs cudaFuncAttributeMaxDynamicSharedMemorySize");
  const dim3 grid((wd + Q_TW - 1) / Q_TW, (h + Q_TH - 1) / Q_TH, n * co_tiles);
  qconv3x3_s8_kernel<<<grid, Q_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), scale, out, h, wd, cin, cout,
      co_tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* qconv_error_string(int code) {
  return code < 0 ? "argument not supported by the kernel"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
