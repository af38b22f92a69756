// Flash-attention forward for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel `_flash_forward` (srganfd_tpu/ops/pallas/attention.py:95,
// body `_flash_kernel`): exact softmax attention
//
//   o[n, t, h, :] = sum_s softmax_s(q[n, t, h, :] . k[n, s, h, :] / sqrt(D)) v[n, s, h, :]
//
// on q, k, v and o laid out (N, T, H, D) and read through element strides
// (the D axis contiguous), f32 or bf16, no mask, no dropout. Scores, the
// running max, the normaliser and the accumulator are f32 whatever the
// input type; the output is rounded to q's type once, as `o_ref[0] = (acc /
// l).astype(...)` does.
//
// Two kernels, chosen by dtype (no fallback from one to the other):
//
// f32, `flash_fwd_kernel<float, D>` (the CUDA-core design): one
// block of 128 threads owns one (batch, head) and 128 consecutive queries,
// one query row per thread, with q (pre-scaled by log2(e) / sqrt(D)) and
// the f32 accumulator for its D outputs in registers. The block walks the
// keys in tiles of 128 staged in shared memory as f32, every thread reading
// the same key at a time (a broadcast); per 32 scores it updates the running
// max, rescales, and adds exp2(s - m) * v: the online softmax of
// srganfd_tpu/ops/pallas/attention.py:72-84, in f32 FMAs.
//
// bf16, `flash_fwd_bf16_kernel<D>` (tensor cores, FlashAttention-2 style):
// a block of 4 warps owns one (batch, head) and 64 queries, each warp 16
// query rows. A warp loads its q rows once as the bf16 A fragment of
// mma.sync.m16n8k16 (one k-step at D = 16, two at D = 32). The block walks
// the keys in tiles of 64: K and V are staged in bf16 by 16-byte cp.async
// into double-buffered shared memory (the next tile loads while this one is
// computed; each thread's copy addresses are fixed once and stepped per
// tile), rows XOR-swizzled so every 8x16-byte ldmatrix phase hits 32
// distinct banks; out-of-range keys are zero-filled (cp.async src-size 0).
// S = q k^T comes out of mma.sync in f32 accumulator registers (bf16
// products are exact, sums f32, as the reference's f32 einsum of bf16
// values); the ragged last tile is masked to -inf in a branch of its own,
// the row max is reduced over the quad with __shfl_xor_sync, and
// p = exp2(s * log2(e)/sqrt(D) - m * log2(e)/sqrt(D)) is one FFMA and one
// ex2 per score, in f32 (q is not pre-scaled in bf16). P stays in
// registers as the A fragment of P V (the accumulator layout of two 8-key
// n-tiles is the A layout of one 16-key k-step), and V is read with
// ldmatrix.trans. P is split into hi = p's top 16 bits and lo = those of
// the exact rest p - hi (|p - hi - lo| < 2^-14 p), and both go through the
// tensor cores against the same V fragment: one bf16 rounding of p (what
// FlashAttention-2 does) moves about one output in ten by two bf16 ulps
// from the f32 reference (tests/test_torch_flash_numerics.py). The split
// uses integer and f32 operations only, no f32 -> bf16 conversions. The
// normaliser sums the f32 p; the output is acc / l, rounded to bf16 once.
// Ragged query rows are computed and not stored. q, k, v and o rows must
// be 16-byte aligned (the wrapper checks).
//
// Bound at the serving shape of `bsrgantrans_x2` (a 256x256 frame gives
// T = 128 * 128 = 16,384 tokens after the stride-2 conv; N = 1, H = 4,
// D = 16, bf16): QK^T and PV are 4 * N * H * T^2 * D = 6.87e10 FLOP, 69 us
// at the H100's 989 TFLOP/s bf16 tensor-core peak; the N * H * T^2 =
// 1.07e9 exponentials, at 16 per clock on each of 132 SMs (4.2e12/s at the
// 1.98 GHz boost clock), take 257 us; q, k, v and o are 8.4 MB, 2.5 us at
// 3.35 TB/s. So the operations bind, and at D = 16 the exponentials, not
// the products, set the bound.
//
// What the bf16 design does about it: one exponential per score plus one
// rescale per row and 64-key tile; the products, with the hi/lo split
// 1.5x the plain count, move to the tensor cores. What holds it back is
// instruction issue on the CUDA cores, about eleven instructions per score
// (max, FFMA, ex2, the normaliser's add and the split's mask, subtract and
// two byte permutes each, and the mma, ldmatrix and rescale share), more
// than the special-function unit's rate: the exponentials are not what
// the kernel waits on, the split's lo half is. Polynomial exp2 on the
// FMA pipe, wgmma and warp specialisation (softmax of one tile under the
// products of the next) are later work. The f32 path stays on the CUDA
// cores (TF32 would not meet its 1e-5 check) at ~4x its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;   // query rows per block, one per thread
constexpr int BK = 128;   // keys per shared-memory tile
constexpr int SUB = 32;   // scores held in registers at a time
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BK % SUB == 0, "a tile holds whole score chunks");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// element strides of the N, T and H axes; the D axis has stride 1
struct Strides {
  long long n, t, h;
};

// One tile of `valid` keys (valid == BK unless MASKED) from shared memory
// into the running (m, l, acc) of this thread's query row.
template <int D, bool MASKED>
__device__ __forceinline__ void attend_tile(const float (*s_k)[D], const float (*s_v)[D],
                                            const float* qr, float* acc, float& m, float& l,
                                            int valid) {
#pragma unroll 1
  for (int j0 = 0; j0 < BK; j0 += SUB) {
    if (MASKED && j0 >= valid) break;  // uniform over the block
    float s[SUB];
    float mx = m;
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) a = fmaf(qr[d], s_k[j0 + j][d], a);
      if (MASKED && j0 + j >= valid) a = -INFINITY;
      s[j] = a;
      mx = fmaxf(mx, a);
    }
    // m = -inf before the first chunk, whose key 0 is always valid, so mx
    // is finite here and the correction is exp2(-inf) = 0
    const float corr = exp2f(m - mx);
    m = mx;
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const float p = exp2f(s[j] - mx);
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, s_v[j0 + j][d], acc[d]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int t_len, int heads, int q_tiles, Strides sq, Strides sk,
                 Strides sv, Strides so, float q_scale) {
  __shared__ __align__(16) float s_k[BK][D];
  __shared__ __align__(16) float s_v[BK][D];

  const int bh = blockIdx.x / q_tiles;
  const int n = bh / heads;
  const int h = bh % heads;
  const int row = (blockIdx.x % q_tiles) * BQ + threadIdx.x;
  const bool live = row < t_len;

  float qr[D], acc[D];
  const T* qp = q + n * sq.n + (long long)row * sq.t + h * sq.h;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? to_f32(qp[d]) * q_scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const T* kb = k + n * sk.n + h * sk.h;
  const T* vb = v + n * sv.n + h * sv.h;
  for (int k0 = 0; k0 < t_len; k0 += BK) {
    for (int e = threadIdx.x; e < BK * D; e += BQ) {
      const int r = e / D, d = e % D;
      const long long key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < t_len) {
        kv = to_f32(kb[key * sk.t + d]);
        vv = to_f32(vb[key * sv.t + d]);
      }
      s_k[r][d] = kv;
      s_v[r][d] = vv;
    }
    __syncthreads();
    const int valid = t_len - k0;
    if (valid >= BK) {
      attend_tile<D, false>(s_k, s_v, qr, acc, m, l, BK);
    } else {
      attend_tile<D, true>(s_k, s_v, qr, acc, m, l, valid);
    }
    __syncthreads();
  }

  if (!live) return;
  T* op = o + n * so.n + (long long)row * so.t + h * so.h;
#pragma unroll
  for (int d = 0; d < D; ++d) store(op + d, acc[d] / l);
}

// ---- bf16: tensor cores -------------------------------------------------

constexpr int FQ = 64;       // query rows per block: 4 warps x 16
constexpr int FK = 64;       // keys per staged tile
constexpr int FTHREADS = 128;

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
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
// (not volatile: a pure function of its registers, free to be scheduled)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p ~ hi + lo, hi and lo bf16 pairs (low half = the first element), both
// by truncation: hi keeps p's top 16 bits, lo those of the exact rest
// p - hi, so |p - hi - lo| < 2^-14 |p|. Integer and f32 operations only:
// f32 -> bf16 conversions run at 16 a clock on an SM, the exponentials'
// rate, and would double the load on that pipe.
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(p0), u1 = __float_as_uint(p1);
  hi = __byte_perm(u0, u1, 0x7632);
  const float r0 = p0 - __uint_as_float(u0 & 0xffff0000u);
  const float r1 = p1 - __uint_as_float(u1 & 0xffff0000u);
  lo = __byte_perm(__float_as_uint(r0), __float_as_uint(r1), 0x7632);
}

// 16-byte unit c of row r of a tile whose rows hold D bf16 (D / 8 units):
// the unit index is XORed with a function of r so that 8 consecutive rows
// at one unit index (one ldmatrix phase) fall into 8 distinct bank groups
template <int D>
__device__ __forceinline__ int kv_unit(int r, int c) {
  constexpr int UNITS = D / 8;     // 2 or 4
  constexpr int RUN = 8 / UNITS;   // rows that cover the 8 bank groups once
  return r * UNITS + (c ^ ((r / RUN) % UNITS));
}

template <int D>
__global__ void __launch_bounds__(FTHREADS)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      int t_len, int heads, int q_tiles, Strides sq, Strides sk, Strides sv,
                      Strides so, float scale_log2) {
  static_assert(D == 16 || D == 32, "head dim");
  constexpr int UNITS = D / 8;
  __shared__ __align__(128) uint4 s_k[2][FK * UNITS];
  __shared__ __align__(128) uint4 s_v[2][FK * UNITS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // accumulator row group, column pair
  const int bh = blockIdx.x / q_tiles;
  const int n = bh / heads;
  const int h = bh % heads;
  const int row0 = (blockIdx.x % q_tiles) * FQ + warp * 16;

  // q rows row0 + g and row0 + g + 8 as A fragments, one per 16 of D
  uint32_t qa[D / 16][4];
  const __nv_bfloat16* qb = q + n * sq.n + h * sq.h;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + (i & 1) * 8;
      const int col = kk * 16 + (i >> 1) * 8 + tig * 2;
      qa[kk][i] = row < t_len ? *reinterpret_cast<const uint32_t*>(qb + (long long)row * sq.t + col)
                              : 0u;
    }

  // each thread's 16-byte copies of a tile: the first half of K, the rest
  // of V; source rows, shared-memory offsets and steps fixed up front
  constexpr int LOADS = 2 * FK * UNITS / FTHREADS;
  static_assert(FK * UNITS % FTHREADS == 0, "a copy lies wholly in K or in V");
  const __nv_bfloat16* kb = k + n * sk.n + h * sk.h;
  const __nv_bfloat16* vb = v + n * sv.n + h * sv.h;
  const __nv_bfloat16* src[LOADS];
  uint32_t dst[LOADS];
  int key[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const bool is_v = i >= LOADS / 2;
    const int u = (threadIdx.x + i * FTHREADS) % (FK * UNITS);
    key[i] = u / UNITS;
    src[i] = (is_v ? vb + key[i] * sv.t : kb + key[i] * sk.t) + (u % UNITS) * 8;
    dst[i] = smem_u32((is_v ? s_v[0] : s_k[0]) + kv_unit<D>(key[i], u % UNITS));
  }
  const long long k_step = FK * sk.t, v_step = FK * sv.t;
  constexpr uint32_t BUF_BYTES = FK * UNITS * 16;
  // tile j of K and V into buffer j & 1; called for j = 0, 1, 2, ... in turn
  auto load_tile = [&](int j) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const bool ok = j * FK + key[i] < t_len;
      cp_async16(dst[i] + (j & 1) * BUF_BYTES, ok ? src[i] : kb, ok);
      src[i] += i >= LOADS / 2 ? v_step : k_step;
    }
    cp_async_commit();
  };

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores, rows g and g + 8
  float l[2] = {0.f, 0.f};              // this thread's share of the normaliser

  // ldmatrix lane roles: lane >> 3 picks the 8x8 matrix, lane & 7 its row
  const int mi = lane >> 3, mr = lane & 7;
  const int n_tiles = (t_len + FK - 1) / FK;
  load_tile(0);
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_tile(j + 1);
    } else {
      cp_async_commit();  // an empty group keeps the wait below uniform
    }
    cp_async_wait1();
    __syncthreads();
    const uint4* tk = s_k[j & 1];
    const uint4* tv = s_v[j & 1];

    // S = q k^T: 8 n-tiles of 8 keys
    float s[FK / 8][4];
#pragma unroll
    for (int t = 0; t < FK / 8; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[t][i] = 0.f;
#pragma unroll
    for (int np = 0; np < FK / 16; ++np)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // matrices: keys +0..7 / +0..7 / +8..15 / +8..15 at d units 2kk, 2kk+1, 2kk, 2kk+1
        uint32_t b[4];
        ldmatrix_x4(smem_u32(tk + kv_unit<D>(np * 16 + (mi >> 1) * 8 + mr, kk * 2 + (mi & 1))), b);
        mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
      }

    const int valid = t_len - j * FK;
    if (valid < FK) {  // the ragged last tile only (uniform over the block)
#pragma unroll
      for (int t = 0; t < FK / 8; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (t * 8 + tig * 2 + (i & 1) >= valid) s[t][i] = -INFINITY;
    }
    // new row max over the quad; the scale is positive, so the max of the
    // raw scores picks the same key
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int t = 0; t < FK / 8; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[t][i]);
    float ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // m = -inf before the first tile, whose key 0 is valid: mx is finite
      // and the correction exp2(-inf) = 0
      const float corr = fast_exp2((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      ms[r] = mx[r] * scale_log2;
      l[r] *= corr;
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        acc[t][2 * r] *= corr;
        acc[t][2 * r + 1] *= corr;
      }
    }

    // o += p v, 16 keys per k-step, p = exp2(s * log2(e)/sqrt(D) - m') split
    // into bf16 hi + lo
#pragma unroll
    for (int kk = 0; kk < FK / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = fast_exp2(fmaf(s[2 * kk][i], scale_log2, -ms[i >> 1]));
        p[4 + i] = fast_exp2(fmaf(s[2 * kk + 1][i], scale_log2, -ms[i >> 1]));
      }
      l[0] += (p[0] + p[1]) + (p[4] + p[5]);
      l[1] += (p[2] + p[3]) + (p[6] + p[7]);
      // A fragment: (row g, keys 0-7), (row g+8, keys 0-7), (row g, keys 8-15), (row g+8, keys 8-15)
      uint32_t hi[4], lo[4];
      split_bf16(p[0], p[1], hi[0], lo[0]);
      split_bf16(p[2], p[3], hi[1], lo[1]);
      split_bf16(p[4], p[5], hi[2], lo[2]);
      split_bf16(p[6], p[7], hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        // matrices: keys +0..7 / +8..15 / +0..7 / +8..15 at d units 2dp, 2dp, 2dp+1, 2dp+1
        uint32_t b[4];
        ldmatrix_x4_trans(smem_u32(tv + kv_unit<D>(kk * 16 + (mi & 1) * 8 + mr, dp * 2 + (mi >> 1))), b);
        mma_bf16(acc[2 * dp], hi, b[0], b[1]);
        mma_bf16(acc[2 * dp], lo, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
        mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* ob = o + n * so.n + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= t_len) continue;
    __nv_bfloat16* orow = ob + (long long)row * so.t + tig * 2;
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
      *reinterpret_cast<uint32_t*>(orow + t * 8) =
          pack_bf16(acc[t][2 * r] / l[r], acc[t][2 * r + 1] / l[r]);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int n, int t, int h,
               const Strides* st, cudaStream_t stream) {
  const int q_tiles = (t + BQ - 1) / BQ;
  const long long blocks = (long long)n * h * q_tiles;
  if (blocks > 0x7fffffffLL) return -1;
  const float q_scale = LOG2E / sqrtf((float)D);
  flash_fwd_kernel<float, D><<<(unsigned)blocks, BQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), t, h, q_tiles, st[0], st[1], st[2], st[3], q_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int n, int t, int h,
                const Strides* st, cudaStream_t stream) {
  const int q_tiles = (t + FQ - 1) / FQ;
  const long long blocks = (long long)n * h * q_tiles;
  if (blocks > 0x7fffffffLL) return -1;
  using bf = __nv_bfloat16;
  flash_fwd_bf16_kernel<D><<<(unsigned)blocks, FTHREADS, 0, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<bf*>(o), t, h, q_tiles, st[0], st[1], st[2], st[3],
      LOG2E / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point. q, k, v, o: (n, t, h, d) with element strides
// strides[3 * i + {0, 1, 2}] for the N, T and H axes of q, k, v, o in turn
// (D contiguous). dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor
// cores; rows 16-byte aligned); d: 16 or 32. Returns
// cudaGetLastError() after the launch, or -1 for arguments the kernel does
// not take. Launches on `stream`; does not synchronise.
extern "C" int flash_attention_cuda(const void* q, const void* k, const void* v, void* o, int n,
                                    int t, int h, int d, const long long* strides, int dtype,
                                    void* stream) {
  if (n <= 0 || t <= 0 || h <= 0) return -1;
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 16) return launch_f32<16>(q, k, v, o, n, t, h, st, s);
  if (dtype == 0 && d == 32) return launch_f32<32>(q, k, v, o, n, t, h, st, s);
  if (dtype == 1 && d == 16) return launch_bf16<16>(q, k, v, o, n, t, h, st, s);
  if (dtype == 1 && d == 32) return launch_bf16<32>(q, k, v, o, n, t, h, st, s);
  return -1;
}

extern "C" const char* flash_attention_error_string(int code) {
  return code < 0 ? "argument not supported by the kernel"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
