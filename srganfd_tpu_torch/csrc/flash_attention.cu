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
// on the tensor cores with the online softmax of
// srganfd_tpu/ops/pallas/attention.py:72-84 over key tiles of 64. q, k, v and
// o rows must be 16-byte aligned (the wrapper checks).
//
// bf16, `flash_fwd_bf16_kernel<D>` (wgmma fed by the tensor memory
// accelerator): a block owns one (batch, head) and 64 queries for each of
// its consumer warpgroups (four at D = 16, two at D = 32; one block a
// multiprocessor), and one producer warp. The producer keeps K and V tiles
// of 64 keys in flight in a ring of 4 stages: per tile one thread asks for
// tensor-map boxes of 8 of D x 64 keys over the (N, T, H, D) strides (zeros
// past T), which land as [D / 8][key][8] core matrices, completing on the
// stage's mbarrier; both consumers release a stage once the products that
// read it are done. A consumer warpgroup holds its q rows in registers as
// the A operands of S = q k^T, one wgmma.m64n64k16 per 16 of D (K a K-major
// B: bf16 products exact, sums f32, as the reference's f32 einsum of bf16
// values). Its 32 scores a thread come out in the accumulator layout, which
// is the A layout of P V: the ragged last tile is masked to -inf in a branch
// of its own, the row max is reduced over the quad with __shfl_xor_sync,
// and p = exp2(s * log2(e)/sqrt(D) - m * log2(e)/sqrt(D)) is one FFMA and
// one ex2 per score, in f32 (q is not pre-scaled in bf16). P is split into
// hi = p's top 16 bits and lo = those of the exact rest p - hi (|p - hi -
// lo| < 2^-14 p) with integer and f32 operations only, and both go through
// wgmma.m64n(D + 8)k16 against V as an MN-major B whose 8 extra columns are
// a block of ones beside it in the stage: the products that give P V give
// the normaliser, sum(hi + lo), in the same accumulator (so it is rescaled
// with it and costs no add per score). One bf16 rounding of p (what
// FlashAttention-2 does) moves about one output in ten by two bf16 ulps
// from the f32 reference (tests/test_torch_flash_numerics.py). At D = 32 P
// V is left running while the warpgroup waits for the next tile and issues
// its S; at D = 16 (four warpgroups, 120 registers a thread) it is waited
// for at the tile's end. The other warpgroups run their softmax under a
// warpgroup's products. The output is acc / l,
// rounded to bf16 once; ragged query rows are computed and not stored.
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
// rescale per row and 64-key tile; the products, with the hi/lo split 1.5x
// the plain count and the normaliser's columns, on the tensor cores with no
// ldmatrix, the copies on the TMA. Per score the CUDA cores issue the max,
// the FFMA, the ex2 and the split's mask, subtract and two byte permutes
// (half each): six instructions where the mma.sync kernel took about
// eleven. What still holds it back, as its clock64 counters read on the card
// (`rdb_bwd_study.py --mode probe`; PERF.md §6): the softmax, ~990 cycles a
// warpgroup's 64 x 64 tile with the four of a multiprocessor sharing its
// exponential unit and issue slots, against ~150 in S's products and ~160
// waiting for K and V; the card ran at its 1,980 MHz clock meanwhile.
//
// f32 at the same shape: three TF32 products per pair are 3 * 6.87e10
// FLOP, 417 us at the H100's 495 TFLOP/s dense TF32 peak, above the
// exponentials' 257 us (1,026 us for one product each at the CUDA cores'
// 67 TFLOP/s f32 peak). Beside the 3x products, the f32 kernel splits
// every p (and every q, k and v element once), and reads each K and V
// fragment element with a 64-bit shared load where bf16 uses ldmatrix.

#include <cuda.h>  // CUtensorMap and its enums (the encoder is taken from the runtime at first use)
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

template <int N>
struct int_constant {};

// ---- bf16: wgmma fed by the tensor memory accelerator ---------------------

constexpr int FQ = 64;       // query rows a warpgroup (the f32 kernel: a block of 4 warps x 16)
constexpr int FK = 64;       // keys a tile
constexpr int FTHREADS = 128;                    // the f32 kernel's block
// bf16: consumer warpgroups a block, FQ queries each, and one producer
// warp; one block a multiprocessor. Four at D = 16 (120 registers a thread:
// P V is waited for at each tile's end, or ptxas serialises every wgmma,
// C7512; two blocks of two would have 112 and serialise too); D = 32 keeps
// P V in flight under the next tile, which needs more registers: two
template <int D>
__host__ __device__ constexpr int consumers() { return D == 16 ? 4 : 2; }
template <int D>
__host__ __device__ constexpr int ws_threads() { return 128 * consumers<D>() + 32; }
constexpr int RING = 4;                          // K and V tiles in flight

// One stage of the bf16 kernel's ring: K and V as [D / 8][64 keys][8] (one
// 1024-byte block of core matrices per 8 of D, as tensor-map boxes of 8 x 64
// land), then 64 x 8 ones, the column block that P V's products turn into the
// normaliser
template <int D>
struct Stage {
  static constexpr int V = D / 8 * 1024, ONES = 2 * V, BYTES = ONES + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
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

// A shared-memory matrix descriptor without swizzle: core matrices of 8 rows
// of 16 bytes, each 128 contiguous bytes; `lbo` the byte stride between core
// matrices along K, `sbo` along N, for K-major and MN-major operands alike
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// shared memory written by threads (the ones), then read by wgmma
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// keeps the compiler from moving reads or writes of registers that a wgmma
// reads or writes across its issue and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64 f32) = A (64 x 16 bf16, registers) * B (16 x 64 bf16, K-major
// in shared memory) (+ d where acc != 0). Each warp of the warpgroup holds 16
// rows of A in mma.sync's m16n8k16 A layout, and of d: thread t holds rows 16
// (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1), d[4 j + {0,
// 1}] and, 8 rows on, d[4 j + {2, 3}]
__device__ __forceinline__ void wgmma_s(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x N f32) += A (64 x 16 bf16, registers) * B (16 x N bf16, MN-major in
// shared memory), N = 24 (D = 16) or 40 (D = 32): D outputs and 8 columns
// of the normaliser
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t db, int_constant<24>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t db, int_constant<40>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n@P1 bra DONE;\nbra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// a 4-d box (d, t, h, n) of `map` into shared memory, completing on `bar`;
// rows past T read as zero
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar, int d, int t, int h,
                                          int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(t), "r"(h), "r"(n)
      : "memory");
}

#ifdef SRGANFD_PROBE
// clock64 phase counters, summed over every consumer warpgroup and key tile
// of the launches since the last read: [0] waiting for a K/V tile, [1] S =
// q k^T (issue to wait, with the tile before's P V still on the tensor
// cores), [2] the softmax and the split up to P V's issue, [3] tiles, [4] the
// producer waiting for a free stage, [5] P V's issue
__device__ unsigned long long probe_sums[8];
#define PROBE(...) __VA_ARGS__
#else
#define PROBE(...)
#endif

// A block owns one (batch, head) and consumers<D>() x 64 queries. The producer
// warp keeps K and V tiles of 64 keys in flight in a ring of RING stages, by
// tensor-map boxes of 8 of D x 64 keys (zeros past T), each stage released
// by both consumer warpgroups once their products have read it. A consumer
// warpgroup holds its 64 q rows in registers as wgmma A operands and, per
// tile: S = q k^T (m64n64k16 wgmma, K a K-major B), the mask of the ragged
// last tile, the online max over a quad, the rescale of its accumulator, p =
// exp2(s * log2(e)/sqrt(D) - m * log2(e)/sqrt(D)) (one FFMA and one ex2),
// p split into bf16 hi + lo in registers, which are S's accumulator layout
// and so the A operands of P V; then P V as two m64n(D + 8)k16 wgmmas a
// 16-key step (hi, then lo; V an MN-major B with a block of ones beside it,
// so the same products give the normaliser), at D = 32 left running under
// the next tile's wait and S.
template <int D>
__global__ void __launch_bounds__(ws_threads<D>(), 1)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o, int t_len, int heads,
                          int q_blocks, Strides sq, Strides so, float scale_log2,
                          const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v) {
  static_assert(D == 16 || D == 32, "head dim");
  constexpr int NV = D + 8, STAGE = Stage<D>::BYTES;
  extern __shared__ __align__(128) uint8_t sm8[];
  uint8_t* sm = align1024(sm8);
  const uint32_t full0 = smem_u32(sm + RING * STAGE), empty0 = full0 + 8 * RING;
  // the warp index through a shuffle, so that ptxas sees it warp-uniform: a
  // wgmma under a branch it cannot prove uniform is serialised
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int bh = blockIdx.x / q_blocks, n = bh / heads, h = bh % heads;
  const int n_tiles = (t_len + FK - 1) / FK;

  // the ones beside each stage's V (bf16 1.0 = 0x3f80)
  for (int e = tid; e < RING * 256; e += ws_threads<D>())
    reinterpret_cast<uint32_t*>(sm + (e >> 8) * STAGE + Stage<D>::ONES)[e & 255] = 0x3f803f80u;
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(full0 + 8 * s, 1);                  // the producer's arrive with the boxes' bytes
      mbar_init(empty0 + 8 * s, 4 * consumers<D>());  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prefetch_tensormap(&map_k);
    prefetch_tensormap(&map_v);
  }
  fence_async_smem();
  __syncthreads();

  if (warp == 4 * consumers<D>()) {  // the producer
    if (lane != 0) return;
    PROBE(long long waited = 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % RING;
      PROBE(const long long c0 = clock64());
      if (j >= RING) mbar_wait(empty0 + 8 * s, (j / RING - 1) & 1);
      PROBE(waited += clock64() - c0);
      const uint32_t full = full0 + 8 * s, dst = smem_u32(sm + s * STAGE);
      mbar_expect_tx(full, 2 * FK * D * 2);
#pragma unroll
      for (int dg = 0; dg < D / 8; ++dg) {
        tma_load4(dst + dg * 1024, &map_k, full, dg * 8, j * FK, h, n);
        tma_load4(dst + Stage<D>::V + dg * 1024, &map_v, full, dg * 8, j * FK, h, n);
      }
    }
    PROBE(atomicAdd(&probe_sums[4], (unsigned long long)waited));
    return;
  }

  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, tig = lane & 3;
  const int row0 = (blockIdx.x % q_blocks) * (FQ * consumers<D>()) + wg * FQ + wq * 16;
  // q rows row0 + g and row0 + g + 8 as A operands, one per 16 of D
  uint32_t qa[D / 16][4];
  const __nv_bfloat16* qb = q + n * sq.n + h * sq.h;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + (i & 1) * 8;
      const int col = kk * 16 + (i >> 1) * 8 + tig * 2;
      qa[kk][i] = row < t_len ? *reinterpret_cast<const uint32_t*>(qb + (long long)row * sq.t + col) : 0u;
    }

  float s[FK / 2], acc[NV / 2];  // S; P V's D outputs then the normaliser (columns D .. D + 7, all equal)
  uint32_t ph[FK / 16][4], pl[FK / 16][4];  // P's hi and lo, read by P V until its wait
#pragma unroll
  for (int i = 0; i < FK / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < FK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) ph[kk][i] = pl[kk][i] = 0u;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores, rows g and g + 8
  PROBE(long long pw = 0, ps = 0, px = 0, pv = 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % RING;
    PROBE(const long long c0 = clock64());
    mbar_wait(full0 + 8 * st, (j / RING) & 1);
    PROBE(const long long c1 = clock64());
    const uint32_t kb = smem_u32(sm + st * STAGE);
    fence_regs<FK / 2>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // 16 of D: core matrices 2 kk, 2 kk + 1 along K, 8 keys apart along N
      wgmma_s(s, qa[kk], smem_desc(kb + kk * 2048, 1024, 128), kk);
    wgmma_commit();
    wgmma_wait0();  // S, and the tile before's P V
    fence_regs<FK / 2>(s);
    fence_regs<NV / 2>(acc);
    fence_regs<FK / 4>(&ph[0][0]);
    fence_regs<FK / 4>(&pl[0][0]);
    if (j > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((j - 1) % RING));  // the tile before's K and V are read
    PROBE(const long long c2 = clock64());

    const int valid = t_len - j * FK;
    if (valid < FK) {  // the ragged last tile only (uniform over the block)
#pragma unroll
      for (int i = 0; i < FK / 2; ++i)
        if ((i >> 2) * 8 + tig * 2 + (i & 1) >= valid) s[i] = -INFINITY;
    }
    // new row max over the quad; the scale is positive, so the max of the
    // raw scores picks the same key
    float mx[2] = {m[0], m[1]}, ms[2];
#pragma unroll
    for (int i = 0; i < FK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // m = -inf before the first tile, whose key 0 is valid: mx is finite
      // and the correction exp2(-inf) = 0
      const float corr = fast_exp2((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      ms[r] = mx[r] * scale_log2;
#pragma unroll
      for (int t = 0; t < NV / 8; ++t) {
        acc[4 * t + 2 * r] *= corr;
        acc[4 * t + 2 * r + 1] *= corr;
      }
    }
    // p = exp2(s * log2(e)/sqrt(D) - m'), split into bf16 hi + lo: the A
    // operand of 16-key step kk is (row g, keys 0-7), (row g + 8, keys
    // 0-7), (row g, keys 8-15), (row g + 8, keys 8-15), S's registers 8 kk
    // + {0, 1}, {2, 3}, {4, 5}, {6, 7}
#pragma unroll
    for (int kk = 0; kk < FK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p0 = fast_exp2(fmaf(s[8 * kk + 2 * i], scale_log2, -ms[i & 1]));
        const float p1 = fast_exp2(fmaf(s[8 * kk + 2 * i + 1], scale_log2, -ms[i & 1]));
        split_bf16(p0, p1, ph[kk][i], pl[kk][i]);
      }
    PROBE(const long long c3 = clock64(); pw += c1 - c0; ps += c2 - c1; px += c3 - c2);
    fence_regs<NV / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FK / 16; ++kk) {
      // keys 16 kk .. 16 kk + 15: core matrices 8 keys apart along K, 8 of D apart along N
      const uint64_t db = smem_desc(kb + Stage<D>::V + kk * 256, 128, 1024);
      wgmma_pv(acc, ph[kk], db, int_constant<NV>());
      wgmma_pv(acc, pl[kk], db, int_constant<NV>());
    }
    wgmma_commit();
    if constexpr (consumers<D>() == 4) {
      // at 120 registers a thread, P's halves cannot stay live under the
      // next tile's S: ptxas would serialise every wgmma (C7512)
      wgmma_wait0();
      fence_regs<NV / 2>(acc);
      fence_regs<FK / 4>(&ph[0][0]);
      fence_regs<FK / 4>(&pl[0][0]);
    }
    PROBE(pv += clock64() - c3);
  }
  wgmma_wait0();
  fence_regs<NV / 2>(acc);
  fence_regs<FK / 4>(&ph[0][0]);
  fence_regs<FK / 4>(&pl[0][0]);
  PROBE(if ((tid & 127) == 0) {
    atomicAdd(&probe_sums[0], (unsigned long long)pw);
    atomicAdd(&probe_sums[1], (unsigned long long)ps);
    atomicAdd(&probe_sums[2], (unsigned long long)px);
    atomicAdd(&probe_sums[3], (unsigned long long)n_tiles);
    atomicAdd(&probe_sums[5], (unsigned long long)pv);
  });

  __nv_bfloat16* ob = o + n * so.n + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= t_len) continue;
    const float l = acc[4 * (D / 8) + 2 * r];
    __nv_bfloat16* orow = ob + (long long)row * so.t + tig * 2;
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
      *reinterpret_cast<uint32_t*>(orow + t * 8) = pack_bf16(acc[4 * t + 2 * r] / l, acc[4 * t + 2 * r + 1] / l);
  }
}

// A tensor map of K or V, bf16 (n, t, h, D) read through element strides,
// boxes of 8 of D x 64 keys x 1 head x 1 image, no swizzle, zeros past T;
// cuTensorMapEncodeTiled taken once from the runtime. The stride of an axis
// of size 1 is never used and may be anything: it is replaced by the
// contiguous one. 0, or a cudaError_t / CUresult code.
int encode_kv(CUtensorMap* map, const void* base, const Strides& st, int n, int t, int h, int d) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                             const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                             CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                                    cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || encode == nullptr) return (int)cudaErrorNotSupported;
  }
  const cuuint64_t st_t = t > 1 ? (cuuint64_t)st.t * 2 : (cuuint64_t)d * 2;
  const cuuint64_t st_h = h > 1 ? (cuuint64_t)st.h * 2 : st_t * t;
  const cuuint64_t st_n = n > 1 ? (cuuint64_t)st.n * 2 : st_h * h;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {st_t, st_h, st_n};
  const cuuint32_t box[4] = {8, FK, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, elem,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int n, int t, int h,
                const Strides* st, cudaStream_t stream) {
  const int q_blocks = (t + FQ * consumers<D>() - 1) / (FQ * consumers<D>());
  const long long blocks = (long long)n * h * q_blocks;
  if (blocks > 0x7fffffffLL) return -1;
  CUtensorMap map_k, map_v;
  const int e1 = encode_kv(&map_k, k, st[1], n, t, h, D), e2 = encode_kv(&map_v, v, st[2], n, t, h, D);
  if (e1 || e2) return e1 ? e1 : e2;
  constexpr int smem = 1024 + RING * Stage<D>::BYTES + 16 * RING;  // 1024: the base's alignment
  static_assert(smem <= 48 * 1024, "above 48 KB needs cudaFuncAttributeMaxDynamicSharedMemorySize");
  using bf = __nv_bfloat16;
  flash_fwd_bf16_kernel<D><<<(unsigned)blocks, ws_threads<D>(), smem, stream>>>(
      static_cast<const bf*>(q), static_cast<bf*>(o), t, h, q_blocks, st[0], st[3], LOG2E / sqrtf((float)D), map_k,
      map_v);
  return (int)cudaGetLastError();
}

// ---- f32: tensor cores, split-precision 3xTF32 --------------------------

// x rounded to TF32 (10 explicit mantissa bits) to nearest, ties away from
// zero, as cvt.rna.tf32.f32 does for finite x: the low 13 bits are zero.
// Integer operations, so that the CPU tests replay it bit for bit.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// tf32_rna keeping a NaN a NaN: the carry turns one whose mantissa's top
// bits are all set (the card's own NaN is 0x7fffffff) into -0. Inf rounds
// to itself in tf32_rna.
__device__ __forceinline__ uint32_t tf32_rna_nan(float x) {
  return isnan(x) ? 0x7fffe000u : tf32_rna(x);
}

// x ~ hi + lo, both TF32, |x - hi - lo| <= 2^-22 |x| (x - hi is exact)
// A NaN x gives a NaN hi, so that its products are NaN; lo needs no test.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna_nan(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// split_tf32 for a softmax weight p, whose NaN the row sum l carries
__device__ __forceinline__ void split_tf32_p(float p, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(p);
  lo = tf32_rna(p - __uint_as_float(hi));
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
        // a NaN p reaches the output through l, summed unsplit: P's split
        // (T^2 of them) skips tf32_rna_nan's test
        split_tf32_p(p[0], ph[mt][0], pl[mt][0]);
        split_tf32_p(p[2], ph[mt][1], pl[mt][1]);
        split_tf32_p(p[1], ph[mt][2], pl[mt][2]);
        split_tf32_p(p[3], ph[mt][3], pl[mt][3]);
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

#ifdef SRGANFD_PROBE
// The bf16 kernel's phase counters (see probe_sums) into sums[0..7], then
// zeroed. 0 or a cudaError_t code.
extern "C" int flash_probe_read(unsigned long long* sums) {
  cudaError_t err = cudaMemcpyFromSymbol(sums, probe_sums, sizeof(probe_sums));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(probe_sums, zero, sizeof(zero));
}
#endif
