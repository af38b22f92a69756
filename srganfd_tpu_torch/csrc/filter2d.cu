// Per-sample 2-D filter for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel `filter2d_pallas` (srganfd_tpu/ops/pallas/filter2d.py,
// body `_filter_kernel`), which computes `ops.filters.filter2d`, the blur of
// the BSRGAN degradation chain:
//
//   out[n, h, w, c] = sum_{dy, dx} xpad[n, h + dy, w + dx, c] * k[n, dy, dx]
//
// images (N, H, W, C) f32 channels-last, kernels (N, K, K) f32 with K odd,
// xpad the image reflect-101-padded by K/2 on both spatial axes (the edge
// pixel is not repeated, as in jnp.pad / F.pad mode="reflect"; needs
// K/2 < H and K/2 < W). A correlation: the kernel is not flipped. Products
// and sums in f32 (the JAX chain asks for Precision.HIGHEST), summed over
// dy then dx.
//
// Design (simple first): one block per (sample, 32x32 output tile). The
// tile and its K-1 halo are staged in shared memory one chunk of up to 3
// channels at a time (the chain has C = 3), with the reflect-101 index map
// resolved during the load, so no padded copy of the image is ever made;
// the sample's K*K taps sit in shared memory too and are read as
// broadcasts. Each of the 128 threads owns 8 adjacent output columns of one
// row: for each tap row it loads the 8 + K - 1 input values it needs into
// registers once and runs K * 8 FMAs per channel on them (the tap loop is
// unrolled, K is a template argument), about 5 FMAs per shared-memory
// load. Rows of the staged planes are padded to 1 mod 32 floats so the 32
// lanes of a warp (8 rows x 4 column groups) hit 32 distinct banks. Ragged
// edge tiles are masked at the store.
//
// The TPU kernel's banded-Toeplitz matmuls are not carried over: they exist
// to feed the MXU and inflate the work by (W + K - 1) / K.
//
// Bound at the chain's shape, (16, 320, 320, 3) with K = 25: 16 * 320 *
// 320 * 3 * 625 MAC = 6.14e9 FLOP, 0.092 ms at the H100's 67 TFLOP/s f32
// CUDA-core peak, against 0.012 ms for the 2 x 19.7 MB that must move at
// 3.35 TB/s: bound by the f32 operations (no TF32: the products must be
// f32). What this design leaves on the table: shared-memory loads still
// share the issue slots with the FMAs, and the staging loads are 12-byte
// strided (C = 3 channels-last).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 32;                 // output tile rows
constexpr int TW = 32;                 // output tile columns
constexpr int PX = 8;                  // output columns per thread
constexpr int CP = 3;                  // channels staged per pass
constexpr int THREADS = TH * TW / PX;  // 128
constexpr int KMAX = 31;               // largest K taken

static_assert(TW / PX == 4, "bank layout below assumes 4 column groups per row");

// staged row length: at least TW + K - 1 floats, and 1 mod 32
__host__ __device__ constexpr int staged_width(int k) {
  return ((TW + k - 1 + 30) / 32) * 32 + 1;
}

__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  // only halo cells that feed no output can still be out of range
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

template <int K>
__global__ void __launch_bounds__(THREADS)
filter2d_kernel(const float* __restrict__ images, const float* __restrict__ kernels,
                float* __restrict__ out, int h, int w, int c, int tiles_x) {
  constexpr int PAD = K / 2;
  constexpr int SH = TH + K - 1;
  constexpr int SW = staged_width(K);
  extern __shared__ float smem[];
  float* s_k = smem;                 // K*K taps
  float* s_in = smem + K * K;        // CP planes of SH x SW

  const int tid = threadIdx.x;
  const int row = tid / (TW / PX);          // 0..31
  const int col0 = (tid % (TW / PX)) * PX;  // 0, 8, 16, 24
  const int n = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const float* img = images + (size_t)n * h * w * c;

  for (int i = tid; i < K * K; i += THREADS) s_k[i] = kernels[(size_t)n * K * K + i];

  for (int c0 = 0; c0 < c; c0 += CP) {
    const int cc = c - c0 < CP ? c - c0 : CP;
    __syncthreads();  // the previous pass has finished reading s_in
    for (int i = tid; i < SH * (TW + K - 1); i += THREADS) {
      const int r = i / (TW + K - 1), q = i % (TW + K - 1);
      const int gy = reflect101(ty0 - PAD + r, h);
      const int gx = reflect101(tx0 - PAD + q, w);
      const float* src = img + ((size_t)gy * w + gx) * c + c0;
      for (int cp = 0; cp < cc; ++cp) s_in[(cp * SH + r) * SW + q] = src[cp];
    }
    __syncthreads();

    float acc[CP][PX];
#pragma unroll
    for (int cp = 0; cp < CP; ++cp)
#pragma unroll
      for (int p = 0; p < PX; ++p) acc[cp][p] = 0.f;

#pragma unroll 1
    for (int dy = 0; dy < K; ++dy) {
      const float* tap = s_k + dy * K;
#pragma unroll
      for (int cp = 0; cp < CP; ++cp) {
        if (cp >= cc) break;
        const float* line = s_in + (cp * SH + row + dy) * SW + col0;
        float in[PX + K - 1];
#pragma unroll
        for (int i = 0; i < PX + K - 1; ++i) in[i] = line[i];
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const float kv = tap[dx];
#pragma unroll
          for (int p = 0; p < PX; ++p) acc[cp][p] = fmaf(in[p + dx], kv, acc[cp][p]);
        }
      }
    }

    const int gy = ty0 + row;
    if (gy < h) {
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const int gx = tx0 + col0 + p;
        if (gx >= w) break;
        float* dst = out + (((size_t)n * h + gy) * w + gx) * c + c0;
#pragma unroll
        for (int cp = 0; cp < CP; ++cp)
          if (cp < cc) dst[cp] = acc[cp][p];
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
  const size_t smem = sizeof(float) * (K * K + CP * (TH + K - 1) * staged_width(K));
  if (smem > 48 * 1024) {  // K >= 29: above the default dynamic limit
    const cudaError_t err = cudaFuncSetAttribute(
        filter2d_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  filter2d_kernel<K><<<grid, THREADS, smem, stream>>>(images, kernels, out, h, w, c, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point. Returns 0, the cudaGetLastError() code of a failed
// launch, or -1 for arguments the kernel does not take (K even or above
// KMAX, K/2 >= H or W, empty or oversized grids). Launches on `stream`;
// does not synchronise.
extern "C" int filter2d_cuda(const float* images, const float* kernels, float* out, int n, int h,
                             int w, int c, int k, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || k <= 0 || k % 2 == 0 || k > KMAX) return -1;
  if (k / 2 >= h || k / 2 >= w || n > 65535) return -1;
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
