// Residual Dense Block backward for Hopper (sm_90a), bound through ctypes.
//
// Replaces the VJP of the JAX `rdb_apply` (`_rdb_apply_bwd`,
// srganfd_tpu/ops/pallas/rdb.py:163-166), which is `jax.vjp` of the XLA block
// `_rdb_xla` (:118), recomputed: no `pallas_call`. Here nothing is
// recomputed: the forward (csrc/rdb.cu) hands back its scratch `feat` (N, H,
// W, 4*gc) holding out_1..out_4 in x's dtype, and LeakyReLU keeps the sign,
// so `feat` gives every slope. With src = [x | out_1 .. out_4] and
//
//   z_k = conv_k(src[..., :ch + k*gc]) + b_k,  out_{k+1} = lrelu(z_k) (k < 4),
//   y = 0.2 * z_4 + x,
//
// and g = dL/dy, one f32 buffer D (N, H, W, ch + 4*gc) collects d(x) in its
// first ch channels and d(out_1..out_4) after them, from conv 4 down to 0:
//
//   dy_4 = 0.2 g;  dy_k = slope(out_{k+1}) * D[out_{k+1}]  (k < 4)
//   dgrad_k: D[..., :ch + k*gc] += conv_k's input gradient of dy_k
//   wgrad_k: dW_k[tap][ci][co] = sum_p src[p + tap][ci] dy_k[p][co],
//            db_k[co] = sum_p dy_k[p][co]
//   dx = D[..., :ch]
//
// slope(v) = 1 where v >= 0 (JAX's `where(x >= 0, ...)`: -0.0 takes 1) and
// 0.2 elsewhere. The rounding points are those of autograd through the plain
// version (`rdb_forward_ref`, f32 sums): conv 4's dgrad writes D (x's part
// as g + c_4, the order in which autograd sums x's gradients) and each later
// dgrad adds its f32 sum in place; in bf16 each D[out_k] is rounded to bf16
// before its slope is applied, dx is rounded to x's dtype once (by conv 0's
// dgrad), and dW_k is rounded to bf16 (then widened to f32); db_k is f32.
// One place differs: the bf16 tensor-core products take dy_k in bf16, so
// the 0.2-slope entries of dy_k (0.2 * a bf16 value) and conv 4's dy_4 =
// 0.2 g are rounded to bf16 before dgrad and wgrad; the plain version keeps
// them in f32 (db_k sums the f32 values). The f32 path keeps f32 operands,
// as split-precision 3xTF32 products (csrc/rdb.cu).
//
// Seven launches per RDB backward, all on the caller's stream:
//
// dgrad_k, `dgrad_bf16_kernel` / `dgrad_tf32_kernel` (k = 4 .. 0): the
// forward's implicit GEMM transposed, M = the block's 16x8 output pixels, N
// = a tile of 32 or 64 of conv k's cin input channels, K = 9 * cout_k, the
// taps flipped. Its prologue builds dy_k over the block's 18x10 halo, 16
// (bf16) or 8 (f32) output channels a step, from D and `feat` (or g), into
// shared memory, so there is no elementwise pass; the blocks of the first
// channel tile also write their 16x8 pixels' dy_k, as the tensor cores take
// it, into DY (N, H, W, ch + 4*gc) in x's dtype for the wgrad, and their
// f32 sum over those pixels into a per-tile partial of db_k. bf16: the A
// fragments come from the halo window with ldmatrix as in the forward, the
// B fragments with ldmatrix.trans straight from the forward's packed layout
// [cin/16][tap][cout][16] (rows = K there), mma.sync.m16n8k16. f32: the
// packed [cin/8][hi, lo][tap][cout][8] layout is staged as it is and read
// with 32-bit loads in the B layout (no .trans for 32-bit elements; no
// second pack), three mma.sync.m16n8k8 TF32 products a pair into a fresh
// register per step. The epilogue adds into D (each element of D belongs to
// one block: no atomics); conv 0's writes dx.
//
// wgrad, `wgrad_bf16_kernel` / `wgrad_tf32_kernel`: all five convs in one
// launch after the dgrads (D[out_{k+1}] is final once dgrad_{k+1} ran), a
// GEMM of M = 9 taps x cin, N = cout, K = N*H*W pixels. A block takes one
// (conv, 32 input channels, 32 output channels) job and one of S pixel
// slices (every S-th 16x8 tile), stages the tile's src halo [x | feat] and
// its DY in shared memory (cp.async, double-buffered in bf16), and keeps 9
// taps x 32 x 32 f32 sums in six warps (a warp = one tap row, 16 input
// channels). bf16: both operands are channels-last, K = pixels runs across
// rows, so A and B come with ldmatrix.trans. f32: 32-bit loads from rows
// padded to 40 floats (no bank conflicts), 3xTF32. Each block writes its
// f32 partial once; `reduce_kernel` sums the S partials of every dW element
// and the tiles' db partials in a fixed order, and rounds dW in bf16. No
// float atomics anywhere: a replayed CUDA graph equals the eager run bit for
// bit.
//
// Bound at the training shape, x (16, 72, 72, 64), ch 64, gc 32: dgrad and
// wgrad each do the forward's 3.975e10 FLOP, 7.95e10 in all: 80.5 us at the
// H100's 987.7 TFLOP/s bf16 tensor-core peak, 482 us as three TF32
// products at 495 TFLOP/s. The bytes that must move (x, feat, g read, dx
// written, D's f32 traffic) come to tens of MB, ~10-30 us at 3.35 TB/s:
// operations bound it. What this first design leaves: mma.sync, not wgmma;
// the dgrad stages dy_k synchronously (no overlap within a block: other
// blocks hide it); each dgrad block rebuilds its halo's dy_k, and each
// wgrad job re-reads its tile's DY; the S partials cost ~20 MB of L2
// traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TW = 8;                  // tile columns
constexpr int TH = 16;                 // tile rows
constexpr int SW = TW + 2;             // halo columns
constexpr int HALO = (TH + 2) * SW;    // halo pixels
constexpr int PIX = TH * TW;           // tile pixels
constexpr int THREADS = 128;           // dgrad: 4 warps x 4 output rows
constexpr int WG_THREADS = 192;        // wgrad: 6 warps = 3 tap rows x 2 halves of 32 input channels
constexpr int WCI = 32, WCO = 32;      // wgrad job: input x output channels
constexpr int WSS = WCI + 8;           // f32 wgrad row stride (floats): 8 banks apart, 16-byte aligned
constexpr int F32_NT = 32;             // f32 dgrad channel tile

// ---- shared helpers (as in csrc/rdb.cu) ---------------------------------

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
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// c (16x8 f32) += a (16x8 tf32, row) * b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// TF32 rounding to nearest, ties away, keeping a NaN a NaN; x ~ hi + lo
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ uint32_t tf32_rna_nan(float x) {
  return isnan(x) ? 0x7fffe000u : tf32_rna(x);
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna_nan(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Unit `half` of a row of 2 16-byte units, XOR-swizzled so that 8
// consecutive rows at one half fall into 8 distinct bank groups.
__device__ __forceinline__ int unit2(int r, int half) { return r * 2 + (half ^ ((r >> 2) & 1)); }
// The same for rows of 4 units (32 bf16 channels): 8 consecutive rows at one
// unit, from any first row, fall into 8 distinct bank groups.
__device__ __forceinline__ int unit4(int r, int u) { return r * 4 + (u ^ ((r >> 1) & 3)); }

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ void loadn(const float* p, float* v, int n) {
  for (int i = 0; i < n; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
  }
}
__device__ __forceinline__ void loadn(const bf16* p, float* v, int n) {
  for (int i = 0; i < n; i += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[i + 2 * j] = f.x;
      v[i + 2 * j + 1] = f.y;
    }
  }
}
__device__ __forceinline__ void storen(float* p, const float* v, int n) {
  for (int i = 0; i < n; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
__device__ __forceinline__ void storen(bf16* p, const float* v, int n) {
  for (int i = 0; i < n; i += 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[i + 2 * j], v[i + 2 * j + 1]);
    *reinterpret_cast<uint4*>(p + i) = u;
  }
}

// ---- dgrad -------------------------------------------------------------

template <typename T>
struct DgradArgs {
  const T* g;       // (P, ch): conv 4's dy is 0.2 g
  const T* feat;    // (P, fc): out_1..out_4, their signs the slopes
  float* D;         // (P, cd) f32, cd = ch + fc
  T* DY;            // (P, cd): dy_k as the tensor cores take it, at channel dyo
  float* dbp;       // (tiles, cout) f32: this conv's per-tile db partials
  const T* w;       // this conv's packed weights
  T* dx;            // (P, ch): conv 0's output
  int h, wd, ch, fc, cin, cout, k, ci_tiles, prologue_only;
};

// U channels of dy_k at pixel `pix`, output channel co, in f32 as the plain
// version computes them (before the tensor cores' rounding)
template <typename T, int U>
__device__ __forceinline__ void dy_values(const DgradArgs<T>& a, size_t pix, int co, float* v) {
  if (a.k == 4) {
    loadn(a.g + pix * a.ch + co, v, U);
#pragma unroll
    for (int i = 0; i < U; ++i) v[i] = __fmul_rn(v[i], 0.2f);
    return;
  }
  const int gc = a.fc / 4;
  float f[U];
  loadn(a.D + pix * (a.ch + a.fc) + a.ch + a.k * gc + co, v, U);
  loadn(a.feat + pix * a.fc + a.k * gc + co, f, U);
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const float d = sizeof(T) == 2 ? round_bf16(v[i]) : v[i];
    v[i] = f[i] >= 0.f ? d : __fmul_rn(d, 0.2f);
  }
}

// the f32 sums of one block's 8 (or 4) db channels, across the lanes of one
// parity (the threads' staged half) and then the 4 warps, in a fixed order
template <int U>
__device__ __forceinline__ void db_reduce(float* dbs, float* s_db, int warp, int lane) {
#pragma unroll
  for (int off = 2; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < U; ++i) dbs[i] += __shfl_xor_sync(0xffffffffu, dbs[i], off);
  if (lane < 2)
#pragma unroll
    for (int i = 0; i < U; ++i) s_db[warp * 2 * U + lane * U + i] = dbs[i];
}

// the epilogue shared by both dtypes: s_out holds the block's f32 sums,
// [pixel][NT + 8]
template <typename T, int NT>
__device__ __forceinline__ void dgrad_epilogue(const DgradArgs<T>& a, const float* s_out, int tid,
                                               int ty0, int tx0, size_t img, int ci0) {
  constexpr int OS = NT + 8;
  const int cd = a.ch + a.fc;
  for (int e = tid; e < PIX * (NT / 8); e += THREADS) {
    const int px = e / (NT / 8), cg = e % (NT / 8);
    const int gy = ty0 + px / TW, gx = tx0 + px % TW;
    const int ci = ci0 + cg * 8;
    if (gy >= a.h || gx >= a.wd || ci >= a.cin) continue;
    float v[8], d[8];
    loadn(s_out + px * OS + cg * 8, v, 8);
    const size_t pix = img + (size_t)gy * a.wd + gx;
    if (a.k == 4) {
      // D = g + c_4 in x's part (autograd's order: g arrives first), c_4 elsewhere
      if (ci < a.ch) {
        loadn(a.g + pix * a.ch + ci, d, 8);
#pragma unroll
        for (int o = 0; o < 8; ++o) v[o] = __fadd_rn(d[o], v[o]);
      }
      storen(a.D + pix * cd + ci, v, 8);
    } else {
      loadn(a.D + pix * cd + ci, d, 8);
#pragma unroll
      for (int o = 0; o < 8; ++o) v[o] = __fadd_rn(d[o], v[o]);
      if (a.k == 0)
        storen(a.dx + pix * a.ch + ci, v, 8);  // dx, rounded once
      else
        storen(a.D + pix * cd + ci, v, 8);
    }
  }
}

template <int NT>
constexpr int dgrad_bf16_smem() {
  // dy (16 channels of the halo) + weights (NT x 9 x 16) + db; the
  // epilogue's f32 tile reuses them
  return 16 * (HALO * 2 + (NT / 16) * 9 * 16 * 2) + 4 * 64 > 4 * PIX * (NT + 8)
             ? 16 * (HALO * 2 + (NT / 16) * 9 * 16 * 2) + 4 * 64
             : 4 * PIX * (NT + 8);
}

// bf16 dgrad of conv k, output channels [ci0, ci0 + NT) of image n
template <int NT>
__global__ void __launch_bounds__(THREADS) dgrad_bf16_kernel(DgradArgs<bf16> a) {
  extern __shared__ __align__(128) uint4 smem[];
  constexpr int A_UNITS = HALO * 2;
  constexpr int W_UNITS = (NT / 16) * 9 * 16 * 2;
  uint4* s_a = smem;
  uint4* s_w = smem + A_UNITS;
  float* s_db = reinterpret_cast<float*>(smem + A_UNITS + W_UNITS);  // [4 warps][16]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * TH;
  const int n = blockIdx.z / a.ci_tiles, ci0 = (blockIdx.z % a.ci_tiles) * NT;
  const bool first = blockIdx.z % a.ci_tiles == 0;  // writes DY and the db partials
  const int tile = (n * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const size_t img = (size_t)n * a.h * a.wd;
  const int cd = a.ch + a.fc, gc = a.fc / 4;
  const int dyo = a.k < 4 ? a.ch + a.k * gc : 0;
  const int cout_pad = (a.cout + 15) & ~15;
  const int cin16 = (a.cin + 15) / 16;

  float acc[2][NT / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < NT / 8; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][t][i] = 0.f;

  // ldmatrix lane roles. A (16 pixels x 16 dy channels): as the forward's.
  // B with .trans from rows (tap, co) of 16 input channels: matrices (co
  // 0-7, ci 0-7), (co 8-15, ci 0-7), (co 0-7, ci 8-15), (co 8-15, ci 8-15)
  // are b0, b1 of two n8 tiles.
  int a_pix[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) a_pix[mt] = (warp * 4 + mt * 2 + ((lane >> 3) & 1)) * SW + (lane & 7);
  const int a_half = lane >> 4;
  const int b_row = ((lane >> 3) & 1) * 8 + (lane & 7), b_half = lane >> 4;

  for (int c0 = 0; c0 < a.cout; c0 += 16) {
    if (!a.prologue_only) {
      for (int e = tid; e < W_UNITS; e += THREADS) {
        const int row = e >> 1, half = e & 1;  // row = (j * 9 + tap) * 16 + co
        const int co = row & 15, jt = row >> 4;
        const int cc = ci0 / 16 + jt / 9, tap = jt % 9;
        const bool ok = cc < cin16;
        cp_async16(smem_u32(s_w + unit2(row, half)),
                   ok ? a.w + (((size_t)cc * 9 + tap) * cout_pad + c0 + co) * 16 + half * 8 : a.w, ok);
      }
      cp_async_commit();
    }
    float dbs[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) dbs[i] = 0.f;
    for (int e = tid; e < A_UNITS; e += THREADS) {
      const int p = e >> 1, half = e & 1;
      const int ly = p / SW, lx = p % SW;
      const int gy = ty0 - 1 + ly, gx = tx0 - 1 + lx;
      const int co = c0 + half * 8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.wd && co < a.cout) {
        const size_t pix = img + (size_t)gy * a.wd + gx;
        float v[8];
        dy_values<bf16, 8>(a, pix, co, v);
        storen(reinterpret_cast<bf16*>(&u), v, 8);
        if (first && ly >= 1 && ly <= TH && lx >= 1 && lx <= TW) {
          *reinterpret_cast<uint4*>(a.DY + pix * cd + dyo + co) = u;
#pragma unroll
          for (int i = 0; i < 8; ++i) dbs[i] += v[i];
        }
      }
      s_a[unit2(p, half)] = u;
    }
    if (first) db_reduce<8>(dbs, s_db, warp, lane);
    cp_async_wait0();
    __syncthreads();
    if (first && tid < 16 && c0 + tid < a.cout) {
      const int i = tid & 7, half = tid >> 3;
      float s = 0.f;
      for (int w = 0; w < 4; ++w) s += s_db[w * 16 + half * 8 + i];
      a.dbp[(size_t)tile * a.cout + c0 + tid] = s;
    }
    if (!a.prologue_only) {
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        // dsrc[q] = sum over taps of dy[q - tap + 1] W[tap]: halo shift s
        // reads W's tap 8 - s
        const int shift = (s / 3) * SW + s % 3, tap = 8 - s;
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(smem_u32(s_a + unit2(a_pix[mt] + shift, a_half)), af[mt]);
#pragma unroll
        for (int jn = 0; jn < NT / 16; ++jn) {
          uint32_t b[4];
          ldmatrix_x4_trans(smem_u32(s_w + unit2((jn * 9 + tap) * 16 + b_row, b_half)), b);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * jn], af[mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * jn + 1], af[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (a.prologue_only) return;

  constexpr int OS = NT + 8;
  float* s_out = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < NT / 8; ++t) {
      const int co = t * 8 + tig * 2;
      const int px = (warp * 4 + mt * 2) * TW + g;  // second row: px + TW
      *reinterpret_cast<float2*>(s_out + px * OS + co) = make_float2(acc[mt][t][0], acc[mt][t][1]);
      *reinterpret_cast<float2*>(s_out + (px + TW) * OS + co) = make_float2(acc[mt][t][2], acc[mt][t][3]);
    }
  __syncthreads();
  dgrad_epilogue<bf16, NT>(a, s_out, tid, ty0, tx0, img, ci0);
}

constexpr int dgrad_tf32_smem() {
  // dy hi, lo (8 channels of the halo) + weights (hi, lo: 2 x 4 x 9 x 8 x 8
  // floats) + db; the epilogue's f32 tile reuses them
  return 16 * (HALO * 2 * 2 + 2 * (F32_NT / 8) * 9 * 8 * 2) + 4 * 32 > 4 * PIX * (F32_NT + 8)
             ? 16 * (HALO * 2 * 2 + 2 * (F32_NT / 8) * 9 * 8 * 2) + 4 * 32
             : 4 * PIX * (F32_NT + 8);
}

// f32 dgrad (3xTF32) of conv k, output channels [ci0, ci0 + 32) of image n
__global__ void __launch_bounds__(THREADS) dgrad_tf32_kernel(DgradArgs<float> a) {
  constexpr int NT = F32_NT;
  extern __shared__ __align__(128) uint4 smem[];
  constexpr int A_UNITS = HALO * 2;
  constexpr int W_ROWS = 2 * (NT / 8) * 9 * 8;  // (part, j, tap, co) rows of 8 input channels
  uint4* s_ah = smem;
  uint4* s_al = smem + A_UNITS;
  uint4* s_w = smem + 2 * A_UNITS;
  const float* s_wf = reinterpret_cast<const float*>(s_w);
  float* s_db = reinterpret_cast<float*>(s_w + W_ROWS * 2);  // [4 warps][8]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * TH;
  const int n = blockIdx.z / a.ci_tiles, ci0 = (blockIdx.z % a.ci_tiles) * NT;
  const bool first = blockIdx.z % a.ci_tiles == 0;
  const int tile = (n * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const size_t img = (size_t)n * a.h * a.wd;
  const int cd = a.ch + a.fc, gc = a.fc / 4;
  const int dyo = a.k < 4 ? a.ch + a.k * gc : 0;
  const int cout_pad = (a.cout + 15) & ~15;
  const int cin8 = a.cin / 8;

  // as in the forward's f32 kernel, a step's products go into `part`,
  // added to `acc` in f32 after the step
  float acc[2][NT / 8][4], part[2][NT / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < NT / 8; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][t][i] = part[mt][t][i] = 0.f;

  int a_pix[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) a_pix[mt] = (warp * 4 + mt * 2 + ((lane >> 3) & 1)) * SW + (lane & 7);
  const int a_half = lane >> 4;
  const int g = lane >> 2, tig = lane & 3;

  for (int c0 = 0; c0 < a.cout; c0 += 8) {
    if (!a.prologue_only) {
      for (int e = tid; e < W_ROWS * 2; e += THREADS) {
        const int row = e >> 1, half = e & 1;  // row = ((part * NT/8 + j) * 9 + tap) * 8 + co
        const int co = row & 7, r2 = row >> 3;
        const int tap = r2 % 9, pj = r2 / 9;
        const int j = pj % (NT / 8), prt = pj / (NT / 8);
        const int cc = ci0 / 8 + j;
        const bool ok = cc < cin8;
        cp_async16(smem_u32(s_w + e),
                   ok ? a.w + ((((size_t)cc * 2 + prt) * 9 + tap) * cout_pad + c0 + co) * 8 + half * 4 : a.w,
                   ok);
      }
      cp_async_commit();
    }
    float dbs[4] = {0.f, 0.f, 0.f, 0.f};
    for (int e = tid; e < A_UNITS; e += THREADS) {
      const int p = e >> 1, half = e & 1;
      const int ly = p / SW, lx = p % SW;
      const int gy = ty0 - 1 + ly, gx = tx0 - 1 + lx;
      const int co = c0 + half * 4;
      uint4 hi = make_uint4(0u, 0u, 0u, 0u), lo = hi;
      if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.wd && co < a.cout) {
        const size_t pix = img + (size_t)gy * a.wd + gx;
        float v[4];
        dy_values<float, 4>(a, pix, co, v);
        if (first && ly >= 1 && ly <= TH && lx >= 1 && lx <= TW) {
          storen(a.DY + pix * cd + dyo + co, v, 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) dbs[i] += v[i];
        }
        split_tf32(v[0], hi.x, lo.x);
        split_tf32(v[1], hi.y, lo.y);
        split_tf32(v[2], hi.z, lo.z);
        split_tf32(v[3], hi.w, lo.w);
      }
      s_ah[unit2(p, half)] = hi;
      s_al[unit2(p, half)] = lo;
    }
    if (first) db_reduce<4>(dbs, s_db, warp, lane);
    cp_async_wait0();
    __syncthreads();
    if (first && tid < 8 && c0 + tid < a.cout) {
      const int i = tid & 3, half = tid >> 2;
      float s = 0.f;
      for (int w = 0; w < 4; ++w) s += s_db[w * 8 + half * 4 + i];
      a.dbp[(size_t)tile * a.cout + c0 + tid] = s;
    }
    if (!a.prologue_only) {
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        const int shift = (s / 3) * SW + s % 3, tap = 8 - s;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int u = unit2(a_pix[mt] + shift, a_half);
          ldmatrix_x4(smem_u32(s_ah + u), ah[mt]);
          ldmatrix_x4(smem_u32(s_al + u), al[mt]);
        }
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          // B[k = co][n = ci]: row (tap, co = tig or tig + 4), input channel g
          const float* wh = s_wf + ((j * 9 + tap) * 8) * 8;
          const float* wl = wh + (NT / 8) * 9 * 64;
          const uint32_t bh0 = __float_as_uint(wh[tig * 8 + g]), bh1 = __float_as_uint(wh[(tig + 4) * 8 + g]);
          const uint32_t bl0 = __float_as_uint(wl[tig * 8 + g]), bl1 = __float_as_uint(wl[(tig + 4) * 8 + g]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float* c = part[mt][j];
            mma_tf32(c, al[mt], bh0, bh1);
            mma_tf32(c, ah[mt], bl0, bl1);
            mma_tf32(c, ah[mt], bh0, bh1);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int t = 0; t < NT / 8; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[mt][t][i] += part[mt][t][i];
            part[mt][t][i] = 0.f;
          }
    }
    __syncthreads();
  }
  if (a.prologue_only) return;

  constexpr int OS = NT + 8;
  float* s_out = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < NT / 8; ++t) {
      const int co = t * 8 + tig * 2;
      const int px = (warp * 4 + mt * 2) * TW + g;
      *reinterpret_cast<float2*>(s_out + px * OS + co) = make_float2(acc[mt][t][0], acc[mt][t][1]);
      *reinterpret_cast<float2*>(s_out + (px + TW) * OS + co) = make_float2(acc[mt][t][2], acc[mt][t][3]);
    }
  __syncthreads();
  dgrad_epilogue<float, NT>(a, s_out, tid, ty0, tx0, img, ci0);
}

// ---- wgrad -------------------------------------------------------------

template <typename T>
struct WgradArgs {
  const T* x;       // (P, ch)
  const T* feat;    // (P, fc)
  const T* DY;      // (P, cd)
  float* part;      // (slices, E) f32: each slice's dW partials, the convs' HWIO in order
  int n, h, wd, ch, fc, slices, tiles_y, tiles_x, conv_lo, conv_hi;
  long long elems;  // E
};

struct Job {
  int k, cin, cout, ci0, co0, dyo;
  long long off;  // conv k's first element in a slice's partials
};

// job j of the launch: convs conv_hi down to conv_lo, each in (32 input x
// 32 output channels) tiles
__device__ __forceinline__ Job find_job(int j, int ch, int fc, int conv_lo, int conv_hi) {
  const int gc = fc / 4;
  for (int k = conv_hi; k >= conv_lo; --k) {
    const int cin = ch + k * gc, cout = k < 4 ? gc : ch;
    const int ci_t = (cin + WCI - 1) / WCI, co_t = (cout + WCO - 1) / WCO;
    if (j < ci_t * co_t) {
      long long off = 0;
      for (int q = 0; q < k; ++q) off += 9LL * (ch + q * gc) * (q < 4 ? gc : ch);
      return Job{k, cin, cout, (j / co_t) * WCI, (j % co_t) * WCO, k < 4 ? ch + k * gc : 0, off};
    }
    j -= ci_t * co_t;
  }
  return Job{0, 0, 0, 0, 0, 0, 0};
}

// one tile's pixel origin and image
__device__ __forceinline__ void tile_origin(int t, int tiles_y, int tiles_x, int h, int wd, int& ty0, int& tx0,
                                            size_t& img) {
  const int per = tiles_y * tiles_x;
  const int n = t / per, r = t % per;
  ty0 = (r / tiles_x) * TH;
  tx0 = (r % tiles_x) * TW;
  img = (size_t)n * h * wd;
}

// the f32 partials of one warp's 3 taps x 16 input channels x 32 output
// channels: C rows are input channels, columns output channels
__device__ __forceinline__ void wgrad_store(const Job& job, float* base, float (*acc)[4][4], int ty, int mh,
                                            int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int tx = 0; tx < 3; ++tx)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int tap = ty * 3 + tx;
      const int ci = job.ci0 + mh * 16 + g, co = job.co0 + nt * 8 + tig * 2;
      if (co >= job.cout) continue;
      if (ci < job.cin)
        *reinterpret_cast<float2*>(base + ((size_t)tap * job.cin + ci) * job.cout + co) =
            make_float2(acc[tx][nt][0], acc[tx][nt][1]);
      if (ci + 8 < job.cin)
        *reinterpret_cast<float2*>(base + ((size_t)tap * job.cin + ci + 8) * job.cout + co) =
            make_float2(acc[tx][nt][2], acc[tx][nt][3]);
    }
}

constexpr int WS_UNITS = HALO * 4;  // src halo, 32 bf16 channels: 4 units a pixel
constexpr int WD_UNITS = PIX * 4;   // dy tile, 32 bf16 channels
constexpr int wgrad_bf16_smem() { return 16 * 2 * (WS_UNITS + WD_UNITS); }

__global__ void __launch_bounds__(WG_THREADS) wgrad_bf16_kernel(WgradArgs<bf16> a) {
  extern __shared__ __align__(128) uint4 smem[];
  const Job job = find_job(blockIdx.x, a.ch, a.fc, a.conv_lo, a.conv_hi);
  const int s = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = warp % 3, mh = warp / 3;  // tap row, half of the 32 input channels
  const int cd = a.ch + a.fc;
  const int tiles = a.n * a.tiles_y * a.tiles_x;
  const int count = s < tiles ? (tiles - s + a.slices - 1) / a.slices : 0;

  float acc[3][4][4];
#pragma unroll
  for (int tx = 0; tx < 3; ++tx)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[tx][nt][i] = 0.f;

  auto stage = [&](int buf, int t) {
    int ty0, tx0;
    size_t img;
    tile_origin(t, a.tiles_y, a.tiles_x, a.h, a.wd, ty0, tx0, img);
    uint4* ss = smem + buf * (WS_UNITS + WD_UNITS);
    uint4* sd = ss + WS_UNITS;
    for (int e = tid; e < WS_UNITS; e += WG_THREADS) {
      const int p = e >> 2, u = e & 3;
      const int gy = ty0 - 1 + p / SW, gx = tx0 - 1 + p % SW;
      const int c = job.ci0 + u * 8;  // ch % 8 == 0: 8 channels lie wholly in x or in feat
      const bool ok = gy >= 0 && gy < a.h && gx >= 0 && gx < a.wd && c < job.cin;
      const bf16* src = a.x;
      if (ok) {
        const size_t pix = img + (size_t)gy * a.wd + gx;
        src = c < a.ch ? a.x + pix * a.ch + c : a.feat + pix * a.fc + (c - a.ch);
      }
      cp_async16(smem_u32(ss + unit4(p, u)), src, ok);
    }
    for (int e = tid; e < WD_UNITS; e += WG_THREADS) {
      const int p = e >> 2, u = e & 3;
      const int gy = ty0 + p / TW, gx = tx0 + p % TW;
      const int co = job.co0 + u * 8;
      const bool ok = gy < a.h && gx < a.wd && co < job.cout;
      cp_async16(smem_u32(sd + unit4(p, u)), ok ? a.DY + (img + (size_t)gy * a.wd + gx) * cd + job.dyo + co : a.DY,
                 ok);
    }
    cp_async_commit();
  };

  if (count > 0) stage(0, s);
  for (int i = 0; i < count; ++i) {
    if (i + 1 < count) {
      stage((i + 1) & 1, s + (i + 1) * a.slices);
    } else {
      cp_async_commit();
    }
    cp_async_wait1();
    __syncthreads();
    const uint4* ss = smem + (i & 1) * (WS_UNITS + WD_UNITS);
    const uint4* sd = ss + WS_UNITS;
    const int m = lane >> 3;
#pragma unroll 2
    for (int kk = 0; kk < TH / 2; ++kk) {
      // K = 16 pixels: tile rows 2kk (k 0-7) and 2kk + 1 (k 8-15)
      uint32_t b[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        ldmatrix_x4_trans(smem_u32(sd + unit4((2 * kk + (m & 1)) * TW + (lane & 7), q * 2 + (m >> 1))), b[q]);
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) {
        uint32_t af[4];
        ldmatrix_x4_trans(
            smem_u32(ss + unit4((2 * kk + (m >> 1) + ty) * SW + (lane & 7) + tx, mh * 2 + (m & 1))), af);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[tx][nt], af, b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
    __syncthreads();
  }
  wgrad_store(job, a.part + (size_t)s * a.elems + job.off, acc, ty, mh, lane);
}

constexpr int wgrad_tf32_smem() { return 4 * 2 * (HALO + PIX) * WSS; }

// 4 staged floats at hi[o] split into TF32 hi (in place) and lo[o]
__device__ __forceinline__ void split_unit(float* hi, float* lo, int o) {
  const float4 v = *reinterpret_cast<const float4*>(hi + o);
  uint4 h, l;
  split_tf32(v.x, h.x, l.x);
  split_tf32(v.y, h.y, l.y);
  split_tf32(v.z, h.z, l.z);
  split_tf32(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + o) = h;
  *reinterpret_cast<uint4*>(lo + o) = l;
}

__global__ void __launch_bounds__(WG_THREADS) wgrad_tf32_kernel(WgradArgs<float> a) {
  extern __shared__ __align__(128) uint4 smem[];
  float* s_sh = reinterpret_cast<float*>(smem);  // src halo hi, [pixel][WSS]
  float* s_sl = s_sh + HALO * WSS;               // lo
  float* s_dh = s_sl + HALO * WSS;               // dy tile hi
  float* s_dl = s_dh + PIX * WSS;                // lo
  const Job job = find_job(blockIdx.x, a.ch, a.fc, a.conv_lo, a.conv_hi);
  const int s = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = warp % 3, mh = warp / 3;
  const int g = lane >> 2, tig = lane & 3;
  const int cd = a.ch + a.fc;
  const int tiles = a.n * a.tiles_y * a.tiles_x;
  const int count = s < tiles ? (tiles - s + a.slices - 1) / a.slices : 0;

  float acc[3][4][4], part[3][4][4];
#pragma unroll
  for (int tx = 0; tx < 3; ++tx)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[tx][nt][i] = part[tx][nt][i] = 0.f;

  for (int i = 0; i < count; ++i) {
    int ty0, tx0;
    size_t img;
    tile_origin(s + i * a.slices, a.tiles_y, a.tiles_x, a.h, a.wd, ty0, tx0, img);
    for (int e = tid; e < HALO * 8; e += WG_THREADS) {
      const int p = e >> 3, u = e & 7;
      const int gy = ty0 - 1 + p / SW, gx = tx0 - 1 + p % SW;
      const int c = job.ci0 + u * 4;  // 4 channels lie wholly in x or in feat
      const bool ok = gy >= 0 && gy < a.h && gx >= 0 && gx < a.wd && c < job.cin;
      const float* src = a.x;
      if (ok) {
        const size_t pix = img + (size_t)gy * a.wd + gx;
        src = c < a.ch ? a.x + pix * a.ch + c : a.feat + pix * a.fc + (c - a.ch);
      }
      cp_async16(smem_u32(s_sh + p * WSS + u * 4), src, ok);
    }
    for (int e = tid; e < PIX * 8; e += WG_THREADS) {
      const int p = e >> 3, u = e & 7;
      const int gy = ty0 + p / TW, gx = tx0 + p % TW;
      const int co = job.co0 + u * 4;
      const bool ok = gy < a.h && gx < a.wd && co < job.cout;
      cp_async16(smem_u32(s_dh + p * WSS + u * 4),
                 ok ? a.DY + (img + (size_t)gy * a.wd + gx) * cd + job.dyo + co : a.DY, ok);
    }
    cp_async_commit();
    cp_async_wait0();
    asm volatile("" ::: "memory");
    // this thread's own copies have landed (the loops mirror the copies'):
    // split them into TF32 hi (in place) and lo
    for (int e = tid; e < HALO * 8; e += WG_THREADS) split_unit(s_sh, s_sl, (e >> 3) * WSS + (e & 7) * 4);
    for (int e = tid; e < PIX * 8; e += WG_THREADS) split_unit(s_dh, s_dl, (e >> 3) * WSS + (e & 7) * 4);
    __syncthreads();
    for (int r = 0; r < TH; ++r) {
      // K = 8 pixels, tile row r. B[k = pixel][n = co], A[m = ci][k = pixel]
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int o = (r * TW + tig + 4 * q) * WSS + nt * 8 + g;
          bh[nt][q] = __float_as_uint(s_dh[o]);
          bl[nt][q] = __float_as_uint(s_dl[o]);
        }
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) {
        uint32_t ah[4], al[4];
        const int p0 = (r + ty) * SW + tx + tig;
        const int c = mh * 16 + g;
        const int o[4] = {p0 * WSS + c, p0 * WSS + c + 8, (p0 + 4) * WSS + c, (p0 + 4) * WSS + c + 8};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ah[q] = __float_as_uint(s_sh[o[q]]);
          al[q] = __float_as_uint(s_sl[o[q]]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float* c4 = part[tx][nt];
          mma_tf32(c4, al, bh[nt][0], bh[nt][1]);
          mma_tf32(c4, ah, bl[nt][0], bl[nt][1]);
          mma_tf32(c4, ah, bh[nt][0], bh[nt][1]);
        }
      }
    }
#pragma unroll
    for (int tx = 0; tx < 3; ++tx)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[tx][nt][q] += part[tx][nt][q];
          part[tx][nt][q] = 0.f;
        }
    __syncthreads();
  }
  wgrad_store(job, a.part + (size_t)s * a.elems + job.off, acc, ty, mh, lane);
}

// ---- the fixed-order sums ----------------------------------------------

// out[e] for e < E: dW, the S slices' partials summed in slice order
// (rounded to bf16 for a bf16 block); after them each conv's db, its
// tiles' partials summed in tile order
__global__ void reduce_kernel(const float* part, int slices, long long elems, const float* dbp, int tiles,
                              int ch, int gc, float* out, int bf16_sums) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < elems) {
    float s = 0.f;
    for (int i = 0; i < slices; ++i) s += part[(size_t)i * elems + e];
    out[e] = bf16_sums ? round_bf16(s) : s;
    return;
  }
  long long b = e - elems, doff = 0;
  for (int k = 0; k < 5; ++k) {
    const int cout = k < 4 ? gc : ch;
    if (b < cout) {
      float s = 0.f;
      for (int t = 0; t < tiles; ++t) s += dbp[doff + (size_t)t * cout + b];
      out[e] = s;
      return;
    }
    b -= cout;
    doff += (long long)tiles * cout;
  }
}

// ---- launches ----------------------------------------------------------

size_t packed_numel(int cin, int cout, bool bf16_layout) {
  const size_t cout_pad = (cout + 15) & ~15;
  return bf16_layout ? (size_t)((cin + 15) / 16) * 9 * cout_pad * 16 : (size_t)(cin / 8) * 2 * 9 * cout_pad * 8;
}

template <typename T>
int run_backward(const T* x, const T* feat, const T* g, const T* w, float* D, T* DY, float* part, float* dbp,
                 float* out, T* dx, int n, int h, int wd, int ch, int gc, int want_dx, int slices, int only,
                 cudaStream_t stream) {
  constexpr bool BF = sizeof(T) == 2;
  const int fc = 4 * gc;
  const int tiles_x = (wd + TW - 1) / TW, tiles_y = (h + TH - 1) / TH;
  const int tiles = n * tiles_x * tiles_y;
  long long elems = 0;
  int n_bias = 0;
  size_t woff[5], dboff[5];
  {
    size_t wo = 0, dbo = 0;
    for (int k = 0; k < 5; ++k) {
      const int cin = ch + k * gc, cout = k < 4 ? gc : ch;
      woff[k] = wo;
      dboff[k] = dbo;
      wo += packed_numel(cin, cout, BF);
      dbo += (size_t)tiles * cout;
      elems += 9LL * cin * cout;
      n_bias += cout;
    }
  }
  // dgrad, conv 4 down to 0
  for (int k = 4; k >= 0; --k) {
    if (only >= 0 && only != k) continue;
    const int cin = ch + k * gc, cout = k < 4 ? gc : ch;
    const bool prologue_only = k == 0 && !want_dx;
    const int nt = BF ? (cin % 64 == 0 ? 64 : 32) : F32_NT;
    const int ci_tiles = prologue_only ? 1 : (cin + nt - 1) / nt;
    const dim3 grid(tiles_x, tiles_y, n * ci_tiles);
    DgradArgs<T> a{g, feat, D, DY, dbp + dboff[k], w + woff[k], dx, h, wd, ch, fc, cin, cout, k, ci_tiles,
                   prologue_only ? 1 : 0};
    if constexpr (BF) {
      if (nt == 64)
        dgrad_bf16_kernel<64><<<grid, THREADS, dgrad_bf16_smem<64>(), stream>>>(a);
      else
        dgrad_bf16_kernel<32><<<grid, THREADS, dgrad_bf16_smem<32>(), stream>>>(a);
    } else {
      dgrad_tf32_kernel<<<grid, THREADS, dgrad_tf32_smem(), stream>>>(a);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // wgrad of every conv in one launch (or of conv only - 5)
  int conv_lo = 0, conv_hi = 4;
  if (only >= 5 && only <= 9) conv_lo = conv_hi = only - 5;
  if (only < 0 || (only >= 5 && only <= 9)) {
    int jobs = 0;
    for (int k = conv_lo; k <= conv_hi; ++k) {
      const int cin = ch + k * gc, cout = k < 4 ? gc : ch;
      jobs += ((cin + WCI - 1) / WCI) * ((cout + WCO - 1) / WCO);
    }
    const dim3 grid(jobs, slices);
    WgradArgs<T> a{x, feat, DY, part, n, h, wd, ch, fc, slices, tiles_y, tiles_x, conv_lo, conv_hi, elems};
    if constexpr (BF) {
      static_assert(wgrad_bf16_smem() <= 48 * 1024, "above 48 KB needs the opt-in attribute");
      wgrad_bf16_kernel<<<grid, WG_THREADS, wgrad_bf16_smem(), stream>>>(a);
    } else {
      // above 48 KB only as opted-in dynamic shared memory; once
      static const cudaError_t attr = cudaFuncSetAttribute(
          wgrad_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wgrad_tf32_smem());
      if (attr != cudaSuccess) return (int)attr;
      wgrad_tf32_kernel<<<grid, WG_THREADS, wgrad_tf32_smem(), stream>>>(a);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (only < 0 || only == 10) {
    const long long total = elems + n_bias;
    reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, slices, elems, dbp, tiles, ch, gc,
                                                                        out, BF ? 1 : 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Plain C entry point: the backward of one RDB. x (N, H, W, ch), feat (N,
// H, W, 4*gc) as the forward wrote it, g (N, H, W, ch), w the forward's
// packed weights, all in x's dtype (0 = float32, 1 = bfloat16); scratch D
// (f32) and DY (x's dtype), both (N, H, W, ch + 4*gc); part (slices, E) and
// dbp (tiles, sum of the couts) f32; out (E + sum of the couts) f32: the five
// dW in HWIO, then the five db; dx (N, H, W, ch) in x's dtype unless
// !want_dx. `only` = -1 runs all seven launches; 0-4 one conv's dgrad, 5-9
// one conv's wgrad, 10 the sums (for timing them apart). Returns 0, the
// cudaGetLastError() code of the first failed launch, or -1 for arguments
// the kernels do not take. Launches on `stream`; does not synchronise.
extern "C" int rdb_backward_cuda(const void* x, const void* feat, const void* g, const void* w, float* D, void* DY,
                                 float* part, float* dbp, float* out, void* dx, int n, int h, int wd, int ch, int gc,
                                 int dtype, int want_dx, int slices, int only, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || ch <= 0 || gc <= 0 || ch % 8 || gc % 8 || slices <= 0) return -1;
  if (only < -1 || only > 10) return -1;
  const int widest = ch + 4 * gc;
  if ((h + TH - 1) / TH > 65535 || (long long)n * ((widest + 31) / 32) > 65535 || slices > 65535) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_backward<float>(static_cast<const float*>(x), static_cast<const float*>(feat),
                               static_cast<const float*>(g), static_cast<const float*>(w), D,
                               static_cast<float*>(DY), part, dbp, out, static_cast<float*>(dx), n, h, wd, ch, gc,
                               want_dx, slices, only, s);
  if (dtype == 1)
    return run_backward<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(feat),
                              static_cast<const bf16*>(g), static_cast<const bf16*>(w), D, static_cast<bf16*>(DY),
                              part, dbp, out, static_cast<bf16*>(dx), n, h, wd, ch, gc, want_dx, slices, only, s);
  return -1;
}

extern "C" const char* rdb_backward_error_string(int code) {
  return code < 0 ? "argument not supported by the kernel"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
