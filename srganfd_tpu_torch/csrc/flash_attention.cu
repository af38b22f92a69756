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
// Two kernels, chosen by dtype (no fallback from one to the other), both
// FlashAttention-2 style on the tensor cores: a block of 4 warps owns one
// (batch, head) and a run of queries, each warp 16 query rows (the f32
// kernel 32 at D = 16), and walks the keys in tiles of 64 with the online
// softmax of
// srganfd_tpu/ops/pallas/attention.py:72-84. q, k, v and o rows must be
// 16-byte aligned (the wrapper checks).
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
// Ragged query rows are computed and not stored.
//
// f32, `flash_fwd_tf32_kernel<D, MT>` (split-precision 3xTF32): the same
// tiles over mma.sync.m16n8k8 (TF32 in, f32 accumulate), each warp MT
// m-tiles of 16 query rows (2 at D = 16, so a block owns 128 queries; 1 at
// D = 32, as registers allow). TF32 keeps 10 mantissa bits, which misses
// the f32 check, so every operand is split into two TF32 values, a ~ hi +
// lo (|a - hi - lo| <= 2^-22 |a|), and each fragment pair takes three
// products, a_lo b_hi + a_hi b_lo + a_hi b_hi, the large one last. q is
// split once in registers (2 k-steps at D = 16, 4 at D = 32). K and V tiles
// are loaded into registers one tile ahead (16-byte loads, zeros past the
// last key), split, and stored in shared memory as interleaved (hi, lo)
// pairs, so one 64-bit load fetches both halves of a fragment element; the
// rows are padded so that those loads hit 32 distinct banks per half-warp.
// S comes out in f32 accumulator registers, (g, 2t) and (g, 2t+1) of each
// 8-key n-tile, which is not the TF32 A layout, (g, t) and (g, t+4): the
// registers {c0, c2, c1, c3} are fed as {a0, a1, a2, a3} unchanged, which
// relabels the keys (k-slot t is key 2t, slot t + 4 is key 2t + 1), and the
// V fragment reads V rows 2t and 2t + 1 to match, with shared loads
// (ldmatrix moves 16-bit elements). p = exp2f(s * log2(e)/sqrt(D) - m *
// log2(e)/sqrt(D)) in f32, split like the operands. Each tile's P V goes
// into a fresh accumulator, added to the running one in f32 (acc * corr +
// pv): the tensor cores' f32 accumulation does not round to nearest, so it
// runs over 64 keys at a time. The output is acc / l in f32.
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
// products of the next) are later work.
//
// f32 at the same shape: three TF32 products per pair are 3 * 6.87e10
// FLOP, 417 us at the H100's 495 TFLOP/s dense TF32 peak, above the
// exponentials' 257 us (1,026 us for one product each at the CUDA cores'
// 67 TFLOP/s f32 peak). Beside the 3x products, the f32 kernel splits
// every p (and every q, k and v element once), and reads each K and V
// fragment element with a 64-bit shared load where bf16 uses ldmatrix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// element strides of the N, T and H axes; the D axis has stride 1
struct Strides {
  long long n, t, h;
};

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

// ---- f32: tensor cores, split-precision 3xTF32 --------------------------

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
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in split precision: the two small cross terms first, so that
// hi * hi, the large one, is added last. b0, b1: (hi, lo) pairs.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* a_hi, const uint32_t* a_lo,
                                           const uint2& b0, const uint2& b1) {
  mma_tf32(c, a_lo, b0.x, b1.x);
  mma_tf32(c, a_hi, b0.y, b1.y);
  mma_tf32(c, a_hi, b0.x, b1.x);
}

// 4 floats as 4 interleaved (hi, lo) pairs into shared memory
__device__ __forceinline__ void store_split4(const float4& v, uint32_t* dst) {
  uint4 a, b;
  split_tf32(v.x, a.x, a.y);
  split_tf32(v.y, a.z, a.w);
  split_tf32(v.z, b.x, b.y);
  split_tf32(v.w, b.z, b.w);
  reinterpret_cast<uint4*>(dst)[0] = a;
  reinterpret_cast<uint4*>(dst)[1] = b;
}

// MT m-tiles of 16 query rows per warp: each K and V fragment read from
// shared memory serves MT of them
template <int D, int MT>
__global__ void __launch_bounds__(FTHREADS)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int t_len, int heads,
                      int q_tiles, Strides sq, Strides sk, Strides sv, Strides so, float scale_log2) {
  static_assert(D == 16 || D == 32, "head dim");
  // Rows of (hi, lo) pairs, padded so that the 64-bit fragment reads of a
  // half-warp hit 32 distinct banks: K (key g, d t) at word g * LK + 2t with
  // LK = 2 (D + 4) = 8 mod 32; V (key 2t, d g) at word 2t * LV + 2g with
  // LV = 2 (D + 2), 2 LV = 8 mod 32. Rows stay 16-byte aligned.
  constexpr int LK = 2 * (D + 4), LV = 2 * (D + 2);
  __shared__ __align__(16) uint32_t s_k[FK * LK];
  __shared__ __align__(16) uint32_t s_v[FK * LV];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // fragment row group, column
  const int bh = blockIdx.x / q_tiles;
  const int n = bh / heads;
  const int h = bh % heads;
  const int row0 = (blockIdx.x % q_tiles) * FQ * MT + warp * 16 * MT;

  // q rows row0 + 16 mt + g and + 8 as split A fragments, one per 8 of D
  uint32_t qh[MT][D / 8][4], ql[MT][D / 8][4];
  const float* qb = q + n * sq.n + h * sq.h;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + mt * 16 + g + (i & 1) * 8;
        const int col = kk * 8 + (i >> 1) * 4 + tig;
        split_tf32(row < t_len ? qb[(long long)row * sq.t + col] : 0.f, qh[mt][kk][i], ql[mt][kk][i]);
      }

  // each thread's 16-byte loads of a tile, the same units of K and of V;
  // source rows fixed up front and stepped per tile
  constexpr int UNITS = D / 4;  // 16-byte units of a row
  constexpr int LOADS = FK * UNITS / FTHREADS;
  static_assert(FK * UNITS % FTHREADS == 0, "whole units per thread");
  const float* kp[LOADS];
  const float* vp[LOADS];
  int key[LOADS], col[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int u = threadIdx.x + i * FTHREADS;
    key[i] = u / UNITS;
    col[i] = (u % UNITS) * 4;
    kp[i] = k + n * sk.n + h * sk.h + key[i] * sk.t + col[i];
    vp[i] = v + n * sv.n + h * sv.h + key[i] * sv.t + col[i];
  }
  const long long k_step = FK * sk.t, v_step = FK * sv.t;
  float4 rk[LOADS], rv[LOADS];
  // tile j into registers; called for j = 0, 1, 2, ... in turn
  auto load_tile = [&](int j) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const bool ok = j * FK + key[i] < t_len;
      rk[i] = ok ? *reinterpret_cast<const float4*>(kp[i]) : make_float4(0.f, 0.f, 0.f, 0.f);
      rv[i] = ok ? *reinterpret_cast<const float4*>(vp[i]) : make_float4(0.f, 0.f, 0.f, 0.f);
      kp[i] += k_step;
      vp[i] += v_step;
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      store_split4(rk[i], s_k + key[i] * LK + 2 * col[i]);
      store_split4(rv[i], s_v + key[i] * LV + 2 * col[i]);
    }
  };

  float acc[MT][D / 8][4];
  float m[MT][2], l[MT][2];  // running max of the raw scores (rows g, g + 8); this thread's share of the normaliser
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  const int n_tiles = (t_len + FK - 1) / FK;
  load_tile(0);
  store_tile();
  __syncthreads();
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1);  // in flight while this tile is computed

    // S = q k^T: 8 n-tiles of 8 keys; B = (d t, key g) and (d t + 4, key g)
    float s[MT][FK / 8][4];
#pragma unroll
    for (int t = 0; t < FK / 8; ++t) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][t][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t* r = s_k + (t * 8 + g) * LK + 2 * (kk * 8 + tig);
        const uint2 b0 = *reinterpret_cast<const uint2*>(r), b1 = *reinterpret_cast<const uint2*>(r + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_3xtf32(s[mt][t], qh[mt][kk], ql[mt][kk], b0, b1);
      }
    }

    const int valid = t_len - j * FK;
    if (valid < FK) {  // the ragged last tile only (uniform over the block)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int t = 0; t < FK / 8; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (t * 8 + tig * 2 + (i & 1) >= valid) s[mt][t][i] = -INFINITY;
    }
    // new row max over the quad; the scale is positive, so the max of the
    // raw scores picks the same key
    float ms[MT][2], corr[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int t = 0; t < FK / 8; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[mt][t][i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // m = -inf before the first tile, whose key 0 is valid: mx is finite
        // and the correction exp2(-inf) = 0
        corr[mt][r] = exp2f((m[mt][r] - mx[r]) * scale_log2);
        m[mt][r] = mx[r];
        ms[mt][r] = mx[r] * scale_log2;
        l[mt][r] *= corr[mt][r];
      }
    }

    // pv = p v over this tile, 8 keys per k-step. The S registers {c0, c2,
    // c1, c3} = (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1) are the A
    // fragment with k-slot t = key 2t and slot t + 4 = key 2t + 1, so B =
    // (slot t, d g) is V row 2t and (slot t + 4, d g) V row 2t + 1.
    float pv[MT][D / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[mt][dt][i] = 0.f;
#pragma unroll
    for (int t = 0; t < FK / 8; ++t) {
      uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = exp2f(fmaf(s[mt][t][i], scale_log2, -ms[mt][i >> 1]));
        l[mt][0] += p[0] + p[1];
        l[mt][1] += p[2] + p[3];
        split_tf32(p[0], ph[mt][0], pl[mt][0]);
        split_tf32(p[2], ph[mt][1], pl[mt][1]);
        split_tf32(p[1], ph[mt][2], pl[mt][2]);
        split_tf32(p[3], ph[mt][3], pl[mt][3]);
      }
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const uint32_t* r = s_v + (t * 8 + 2 * tig) * LV + 2 * (dt * 8 + g);
        const uint2 b0 = *reinterpret_cast<const uint2*>(r), b1 = *reinterpret_cast<const uint2*>(r + LV);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_3xtf32(pv[mt][dt], ph[mt], pl[mt], b0, b1);
      }
    }
    // each tile's P V enters the running sum in f32, so the tensor cores'
    // accumulation (which does not round to nearest) runs over 64 keys
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][dt][i] = fmaf(acc[mt][dt][i], corr[mt][i >> 1], pv[mt][dt][i]);

    __syncthreads();  // every warp is done with this tile
    if (j + 1 < n_tiles) {
      store_tile();
      __syncthreads();
    }
  }

  float* ob = o + n * so.n + h * so.h;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int row = row0 + mt * 16 + g + r * 8;
      if (row >= t_len) continue;
      float* orow = ob + (long long)row * so.t + tig * 2;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<float2*>(orow + dt * 8) =
            make_float2(acc[mt][dt][2 * r] / lr, acc[mt][dt][2 * r + 1] / lr);
    }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int n, int t, int h,
               const Strides* st, cudaStream_t stream) {
  // two m-tiles a warp at D = 16; at D = 32 one, as registers allow
  constexpr int MT = D == 16 ? 2 : 1;
  const int q_tiles = (t + FQ * MT - 1) / (FQ * MT);
  const long long blocks = (long long)n * h * q_tiles;
  if (blocks > 0x7fffffffLL) return -1;
  flash_fwd_tf32_kernel<D, MT><<<(unsigned)blocks, FTHREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), t, h, q_tiles, st[0], st[1], st[2], st[3],
      LOG2E / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point. q, k, v, o: (n, t, h, d) with element strides
// strides[3 * i + {0, 1, 2}] for the N, T and H axes of q, k, v, o in turn
// (D contiguous, rows 16-byte aligned). dtype: 0 = float32 (3xTF32),
// 1 = bfloat16; both on the tensor cores; d: 16 or 32. Returns
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
