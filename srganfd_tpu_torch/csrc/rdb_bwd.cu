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
// What bounds it. At the training shape, x (16, 72, 72, 64), ch 64, gc 32,
// dgrad and wgrad each do the forward's 3.975e10 FLOP: 80.5 us at the
// H100's 987.7 TFLOP/s bf16 peak, 482 us as three TF32 products at 495
// TFLOP/s. The rounding points make D an f32 buffer that each dgrad reads
// and writes over its cin channels: ~330 MB a backward, ~100 us at 3.35
// TB/s (a strided f32 prefix read-modify-write by PyTorch reaches ~2.5 TB/s
// on the card), so in bf16 memory is as near a limit as the tensor cores.
// What the design does about each cost:
//
// dy_k is built once, where D[out_{k+1}] becomes final. conv k+1's dgrad is
// the last to add into D[out_{k+1}] (the dgrads run from conv 4 down), so
// the epilogue that owns those gc channels of a pixel tile adds its sum,
// rounds (bf16), applies the slope from `feat`, and writes dy_k into DY
// (N, H, W, ch + 4*gc) in x's dtype, at the channels of out_{k+1} in D,
// with the tile's f32 db_k partial; D[out_{k+1}] itself is never written.
// `dy4_kernel` writes dy_4 = 0.2 g into DY's first ch channels (x's in D)
// with conv 4's partials. No dgrad reads D to build its operand: it copies
// DY, and the wgrad reads the same DY.
//
// bf16 dgrad, `dgrad_wgmma_kernel<NT, TMA>`: `wgmma.mma_async`, M = an 8x8
// pixel tile (72-, 64-, 48- and 32-pixel sides divide by 8; 60 leaves 4
// masked rows and columns of 64), N = NT of conv k's cin input channels in
// one pass (cin up to 160; conv 4's 192 in two halves of 96, as its weights
// must fit in shared memory), K = 9 taps x cout, the taps flipped.
// Persistent blocks, about one a multiprocessor, copy conv k's weights for
// their NT channels once, from the forward's packed [cin/16][tap][cout][16]
// layout into [tap][cout/8][NT/8] core matrices read as an MN-major B (no
// second pack); then every tile's 10x10 dy halo comes in one tensor-map
// box (TMA, zeros past the image, 64- or 128-byte swizzled rows of one
// pixel, three steps in flight on mbarriers), so each tap's shifted window
// is a K-major A descriptor with a one-halo-row stride: no im2col copy and
// no ldmatrix. A block's four warpgroups share a step's halos: two tiles,
// two warpgroups a tile with N = NT / 2, where NT <= 96; one tile, four
// warpgroups with N = NT / 4, above (registers). Each warpgroup reads its D
// (or g) and feat values into registers before the products run; the
// epilogue adds in f32 and writes D, dy_{k-1} with its db partial (warp
// shuffles, then the four warps in order), or dx.
//
// bf16 wgrad, `wgrad_wgmma_kernel<TMA>`: dW for all five convs in one
// launch, a GEMM of M = 64 source channels, N = 64 DY channels, K = pixels,
// both operands channels-last and so MN-major, 128-byte swizzled. A job is
// a (64 source, 64 DY) channel pair that some conv reads (8 at ch 64, gc
// 32, where 32 x 32 jobs took 26): each stages a tile's source halo and DY
// once for 64 x 64 x 9 outputs, by two tensor-map boxes from one thread.
// Three warpgroups, one tap row each, keep 3 x m64n64 f32 accumulators; a
// 4-stage ring, a tile's products queued while the last one's run. Blocks
// take one of S pixel slices (every S-th 8x8 tile), S about one block a
// multiprocessor over the jobs (16 at the training shape: 15.3 MB of
// partials where 32 x 32 jobs wrote ~20 MB), and write their f32 partials
// once; `reduce_kernel` sums the slices of every dW element, and every
// tile's db partial, in a fixed order, and rounds dW in bf16. No float
// atomics anywhere: a replayed CUDA graph equals the eager run bit for bit.
// Shapes the tensor maps do not fit (cout not 32 or 64; ch or 4 gc not a
// multiple of 64) take the same kernels with 16-byte cp.async copies.
//
// What still holds the bf16 backward from its bound, as measured on the
// card: the D round trips (conv 4's dgrad writes 160 channels of f32 D);
// a dgrad warpgroup's wgmma N of 32 to 48, at which the products run below
// the tensor cores' rate; the wgrad's queue of copies and products,
// serialised per tile by one barrier.
//
// f32 (3xTF32; TF32 wgmma takes only K-major operands, and both are MN-major
// here): `dgrad_tf32_kernel` keeps mma.sync.m16n8k8 on 16x8 tiles and
// 32-channel N tiles, now copying dy_k from DY (cp.async) and splitting it
// into TF32 halves in shared memory, with the same epilogue duties as the
// bf16 kernel; `wgrad_tf32_kernel` keeps 32 x 32 jobs, as a 64 x 64 job with
// the 3xTF32 step register (a fresh f32 sum per tile) needs 73,728
// registers, more than a multiprocessor has.

#include <cuda.h>  // CUtensorMap and its enums (the encoder is taken from the runtime at first use)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// f32 path (mma.sync)
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

// bf16 path (wgmma)
constexpr int BT = 8;                  // tile side: 64 pixels, one wgmma M
constexpr int BH = BT + 2;             // halo side
constexpr int BHP = BH * BH;           // halo pixels
constexpr int BPIX = BT * BT;          // tile pixels
constexpr int DG_THREADS = 512;        // bf16 dgrad: four warpgroups, on one or two tiles a step
constexpr int DG_RING = 3;             // its halo ring
constexpr int WW_THREADS = 384;        // wgrad: three warpgroups, one tap row each
constexpr int WC = 64;                 // wgrad job: 64 source x 64 DY channels
constexpr int WSTAGES = 4;             // wgrad copy ring
constexpr int WS_BYTES = (BHP * WC * 2 + 1023) & ~1023;  // a stage's source halo, 1024-byte aligned
constexpr int WD_BYTES = BPIX * WC * 2;  // a stage's DY tile
constexpr int MAX_JOBS = 64;
constexpr int SMEM_MAX = 232448;       // a block's shared memory on the H100

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
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ void loadn(const float* p, float* v, int n) {
  for (int i = 0; i < n; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
  }
}
__device__ __forceinline__ void storen(float* p, const float* v, int n) {
  for (int i = 0; i < n; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

// one tile's pixel origin and image, tiles of th x tw in (image, row, column) order
__device__ __forceinline__ void tile_origin(int t, int tiles_y, int tiles_x, int th, int tw, int h, int wd,
                                            int& ty0, int& tx0, size_t& img) {
  const int per = tiles_y * tiles_x;
  const int n = t / per, r = t % per;
  ty0 = (r / tiles_x) * th;
  tx0 = (r % tiles_x) * tw;
  img = (size_t)n * h * wd;
}

// ---- wgmma ---------------------------------------------------------------

// A shared-memory matrix descriptor without swizzle: core matrices of 8 rows
// of 16 bytes, each 128 contiguous bytes; `lbo` the byte stride between core
// matrices along K, `sbo` along M (A) or N (B), for K-major and MN-major
// operands alike.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t layout = 0) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)layout << 62);
}

// The 128-byte swizzled layout (descriptor layout type 1): rows of 128 bytes,
// the 16-byte chunk c of row r stored at chunk c ^ (r % 8), the XOR taken on
// the address bits, so a buffer starts 1024-byte aligned and a descriptor may
// start at any row. The 64-byte one (type 2, as TMA writes 64-byte rows): the
// chunk c of row r at c ^ (r / 2 % 4).
constexpr uint32_t SW128 = 1, SW64 = 2;
__device__ __forceinline__ int swz_off(int row, int chunk) { return row * 128 + ((chunk ^ (row & 7)) << 4); }
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }
// shared memory written by threads (cp.async included), then read by wgmma
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// a barrier of one warpgroup's 128 threads
__device__ __forceinline__ void wg_barrier(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }

// d (64 x N f32) = A (64 x 16 bf16) * B (16 x N bf16) (+ d where acc != 0),
// both from shared memory; TA / TB = 1 for an MN-major (transposed) operand. The warpgroup's
// thread t holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t
// % 4) (+ 1): d[4 j + {0, 1}] and, 8 rows on, d[4 j + {2, 3}].
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n16(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n40(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
      "%20, %21, p, 1, 1, %23, %24;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n48(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, %27, %28;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 16) wgmma_n16<TA, TB>(d, da, db, acc);
  else if constexpr (N == 32) wgmma_n32<TA, TB>(d, da, db, acc);
  else if constexpr (N == 40) wgmma_n40<TA, TB>(d, da, db, acc);
  else if constexpr (N == 48) wgmma_n48<TA, TB>(d, da, db, acc);
  else wgmma_n64<TA, TB>(d, da, db, acc);
}

// ---- the tensor memory accelerator ----------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n@P1 bra DONE;\nbra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
// the tensor map's descriptor into the cache, ahead of the first box
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// a 4-d box (channels, x, y, image) of `map` at the given start into shared
// memory, completing on `bar`; out-of-bounds elements (the halo past the
// image) read as zero
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c, int x, int y,
                                          int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(x), "r"(y), "r"(n)
      : "memory");
}

// ---- dy_4 ----------------------------------------------------------------

// dy_4 = 0.2 g in x's dtype (as the products take it) into DY's first ch
// channels, and conv 4's db partial of each th x 8 tile: the f32 values
// summed over its pixels in row order. One block a tile, a thread a channel;
// a row's 8 pixels are read together.
template <typename T>
__global__ void dy4_kernel(const T* g, T* DY, float* dbp, int h, int wd, int ch, int cd, int th, int tiles_y,
                           int tiles_x) {
  int ty0, tx0;
  size_t img;
  tile_origin(blockIdx.x, tiles_y, tiles_x, th, 8, h, wd, ty0, tx0, img);
  for (int c = threadIdx.x; c < ch; c += blockDim.x) {
    float s = 0.f;
    for (int py = 0; py < th && ty0 + py < h; ++py) {
      const size_t row = img + (size_t)(ty0 + py) * wd + tx0;
      float v[8];
#pragma unroll
      for (int px = 0; px < 8; ++px) v[px] = tx0 + px < wd ? __fmul_rn(to_f32(g[(row + px) * ch + c]), 0.2f) : 0.f;
#pragma unroll
      for (int px = 0; px < 8; ++px)
        if (tx0 + px < wd) {
          DY[(row + px) * cd + c] = from_f32<T>(v[px]);
          s += v[px];
        }
    }
    dbp[(size_t)blockIdx.x * ch + c] = s;
  }
}

// ---- dgrad -------------------------------------------------------------

// f32
template <typename T>
struct DgradArgs {
  T* DY;            // (P, cd): reads dy_k, writes dy_{k-1} (at out_k's channels)
  const T* g;       // (P, ch): conv 4's x part starts from g
  const T* feat;    // (P, fc): out_1..out_4, their signs the slopes
  float* D;         // (P, cd) f32, cd = ch + fc
  float* dbp;       // (tiles, gc) f32: conv k-1's per-tile db partials
  const T* w;       // this conv's packed weights
  T* dx;            // (P, ch): conv 0's output
  int n, h, wd, ch, fc, cin, cout, k, tiles_y, tiles_x;
  int ci_tiles;     // blocks a pixel tile's channels are cut into
};

// The bf16 dgrad's warpgroups on a tile: 2 (N = NT / 2) where NT <= 96, so
// a step takes two tiles; else 4 (N = NT / 4): the accumulators and
// read-ahead operands of N = 80 do not fit in 128 registers, and at N = 64
// (conv 2) four warpgroups a tile measured faster on the card.
__host__ __device__ constexpr int dgrad_wg_per_tile(int nt) { return nt <= 96 ? 2 : 4; }

// The bf16 dgrad's shared memory, in bytes: the block's weights, a ring of
// three slots of a step's dy halos, and the db sums ([4 warpgroups][4
// warps][a warpgroup's channels] f32).
struct DgradSmem {
  int w, halo, total;
  __host__ __device__ DgradSmem(int nt, int cout) {
    const int cout_pad = (cout + 15) & ~15, per_step = 4 / dgrad_wg_per_tile(nt);
    w = (9 * cout_pad * nt * 2 + 1023) & ~1023;
    halo = (cout_pad * BHP * 2 + 1023) & ~1023;
    total = 1024 + w + DG_RING * per_step * halo + 16 * (nt / dgrad_wg_per_tile(nt)) * 4 +
            DG_RING * 8;  // 1024: the base's alignment; mbarriers
  }
};

// bf16 dgrad of conv k: persistent blocks over steps of 4 / QW pixel tiles,
// input channels [ci0, ci0 + NT); a tile's QW warpgroups take NT / QW
// channels each. With TMA (cout 32 or 64: a halo pixel is one 64- or
// 128-byte swizzled row) one thread copies each tile's dy halo as one
// tensor-map box, zeros past the image, completing on the slot's mbarrier;
// else every thread copies 16-byte units (cp.async) into core matrices
template <int NT, bool TMA>
__global__ void __launch_bounds__(DG_THREADS, 1) dgrad_wgmma_kernel(DgradArgs<bf16> a,
                                                                    const __grid_constant__ CUtensorMap map_dy) {
  constexpr int QW = dgrad_wg_per_tile(NT), STEP = 4 / QW;  // warpgroups a tile, tiles a step
  constexpr int NW = NT / QW;                                // a warpgroup's channels: its wgmma N
  extern __shared__ __align__(128) uint8_t sm8[];
  const int cout_pad = (a.cout + 15) & ~15, co8 = cout_pad / 8;
  const int cd = a.ch + a.fc, gc = a.fc / 4;
  const DgradSmem L(NT, a.cout);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  uint8_t* s_w = align1024(sm8);  // the swizzled halos start 1024-byte aligned
  uint8_t* s_h = s_w + L.w;       // the halo ring
  float* s_db = reinterpret_cast<float*>(s_h + DG_RING * STEP * L.halo) + wg * 4 * NW;
  const uint32_t bar0 = smem_u32(s_h + DG_RING * STEP * L.halo + 16 * NW * 4);  // the slots' mbarriers (TMA)
  const int rb = a.cout * 2;                                             // TMA: a halo pixel's bytes
  const uint32_t layout = rb == 128 ? SW128 : SW64;
  const int ci0 = (blockIdx.x % a.ci_tiles) * NT, cw = ci0 + (wg % QW) * NW;
  const int pt = wg / QW;  // this warpgroup's tile of a step
  // the block's steps slot, slot + nslots, ..: a step's tiles are step * STEP + (0 .. STEP - 1)
  const int slot = blockIdx.x / a.ci_tiles, nslots = gridDim.x / a.ci_tiles;
  const int tiles = a.n * a.tiles_y * a.tiles_x, steps = (tiles + STEP - 1) / STEP;
  const int dyo = a.k < 4 ? a.ch + a.k * gc : 0;
  const int cin16 = (a.cin + 15) / 16;
  const int fin0 = a.k > 0 ? a.ch + (a.k - 1) * gc : cd;  // out_k's channels: D final here, dy_{k-1} out

  // the block's weights, once: 16-byte unit (tap, co, 8 input channels) at
  // core matrix (tap, co / 8, ci / 8), row co % 8
  for (int e = tid; e < 9 * cout_pad * (NT / 8); e += DG_THREADS) {
    const int ci8 = e % (NT / 8), rest = e / (NT / 8);
    const int co = rest % cout_pad, tap = rest / cout_pad;
    const int cc = (ci0 >> 4) + (ci8 >> 1);
    const bool ok = cc < cin16;
    cp_async16(smem_u32(s_w + ((tap * co8 + (co >> 3)) * (NT / 8) + ci8) * 128 + (co & 7) * 16),
               ok ? a.w + (((size_t)cc * 9 + tap) * cout_pad + co) * 16 + (ci8 & 1) * 8 : a.w, ok);
  }
  cp_async_commit();

  // step st's dy_k halos (one a tile) into ring slot `buf`, [cout / 8][halo
  // pixel][8 channels] (TMA: [halo pixel][cout], swizzled), zero outside
  // the image and past cout; one commit group
  auto stage = [&](int buf, int st) {
    if constexpr (TMA) {
      if (tid == 0 && st < steps) {
        const int per = a.tiles_y * a.tiles_x, t0 = st * STEP;
        const int valid = tiles - t0 < STEP ? tiles - t0 : STEP;
        const uint32_t bar = bar0 + buf * 8;
        mbar_expect_tx(bar, valid * BHP * rb);
        for (int p = 0; p < valid; ++p) {
          const int t = t0 + p, ty0 = (t % per) / a.tiles_x * BT, tx0 = (t % per) % a.tiles_x * BT;
          tma_load4(smem_u32(s_h + (buf * STEP + p) * L.halo), &map_dy, bar, dyo, tx0 - 1, ty0 - 1, t / per);
        }
      }
      return;
    }
    for (int p = 0; p < STEP; ++p) {
      const int t = st * STEP + p;
      if (st >= steps || t >= tiles) break;
      int ty0, tx0;
      size_t img;
      tile_origin(t, a.tiles_y, a.tiles_x, BT, BT, a.h, a.wd, ty0, tx0, img);
      uint8_t* dst = s_h + (buf * STEP + p) * L.halo;
      for (int e = tid; e < BHP * co8; e += DG_THREADS) {
        const int q = e / co8, c8 = e % co8;
        const int gy = ty0 - 1 + q / BH, gx = tx0 - 1 + q % BH;
        const bool ok = gy >= 0 && gy < a.h && gx >= 0 && gx < a.wd && c8 * 8 < a.cout;
        cp_async16(smem_u32(dst + (c8 * BHP + q) * 16),
                   ok ? a.DY + (img + (size_t)gy * a.wd + gx) * cd + dyo + c8 * 8 : a.DY, ok);
      }
    }
    cp_async_commit();
  };
  if constexpr (TMA) {
    if (tid == 0) {
      prefetch_tensormap(&map_dy);
      for (int q = 0; q < DG_RING; ++q) mbar_init(bar0 + q * 8);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cp_async_wait0();  // the weights
    fence_async_smem();
    __syncthreads();
  }
  for (int i = 0; i < DG_RING - 1; ++i) stage(i, slot + i * nslots);

  const uint32_t w_base = smem_u32(s_w) + (wg % QW) * (NW / 8) * 128, h_base = smem_u32(s_h) + pt * L.halo;
  const int g = lane >> 2, tig = lane & 3;
  float acc[NW / 2];
  float2 dv[NW / 8][2];    // D, or (conv 4) g in x's part
  uint32_t fv[NW / 8][2];  // feat's two bf16 values, out_k's channels only
  int i = 0;
  for (int st = slot; st < steps; st += nslots, ++i) {
    // this warpgroup's tile (past the last tile in a last step: products on zeros, nothing stored)
    const int t = st * STEP + pt;
    int ty0, tx0;
    size_t img;
    tile_origin(t, a.tiles_y, a.tiles_x, BT, BT, a.h, a.wd, ty0, tx0, img);
    // this thread's pixels: rows 2 warp (+ 1) of the tile, column g
    bool in[2];
    size_t pix[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int gy = ty0 + 2 * warp + hr, gx = tx0 + g;
      in[hr] = t < tiles && gy < a.h && gx < a.wd;
      pix[hr] = img + (size_t)(in[hr] ? gy : 0) * a.wd + (in[hr] ? gx : 0);
    }
    // the epilogue's operands, read while the halo lands and the products run
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int c8 = cw + 8 * j, ci = c8 + 2 * tig;
      const bool fin = c8 >= fin0 && c8 < fin0 + gc;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        dv[j][hr] = make_float2(0.f, 0.f);
        fv[j][hr] = 0u;
        if (!in[hr] || ci >= a.cin) continue;
        if (a.k < 4)
          dv[j][hr] = *reinterpret_cast<const float2*>(a.D + pix[hr] * cd + ci);
        else if (ci < a.ch)
          dv[j][hr] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.g + pix[hr] * a.ch + ci));
        if (fin) fv[j][hr] = *reinterpret_cast<const uint32_t*>(a.feat + pix[hr] * a.fc + ci - a.ch);
      }
    }
    if constexpr (TMA) {
      mbar_wait(bar0 + (i % DG_RING) * 8, (i / DG_RING) & 1);  // the step's halos
    } else {
      cp_async_wait1();  // the step's halos (and the weights); the next step's may still fly
      fence_async_smem();
    }
    __syncthreads();  // visible to all; every warpgroup is done with the last step's slot
    stage((i + DG_RING - 1) % DG_RING, st + (DG_RING - 1) * nslots);
    const uint32_t hb = h_base + (i % DG_RING) * STEP * L.halo;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      // dsrc[q] = sum over taps of dy[q - tap + 1] W[tap]: halo shift s reads W's tap 8 - s
      const int shift = (s / 3) * BH + s % 3, tap = 8 - s;
      for (int c = 0; c < co8; c += 2) {
        const uint64_t da = TMA ? smem_desc(hb + shift * rb + c * 16, 16, BH * rb, layout)
                                : smem_desc(hb + (c * BHP + shift) * 16, BHP * 16, BH * 16);
        const uint64_t db = smem_desc(w_base + (tap * co8 + c) * (NT / 8) * 128, NT * 16, 128);
        wgmma<NW, 0, 1>(acc, da, db, s > 0 || c > 0);
      }
    }
    wgmma_commit();
    wgmma_wait0();

    bool any_fin = false;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int c8 = cw + 8 * j, ci = c8 + 2 * tig;
      const bool fin = c8 >= fin0 && c8 < fin0 + gc && c8 < a.cin;  // warp-uniform
      any_fin |= fin;
      float db0 = 0.f, db1 = 0.f;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if (!in[hr] || ci >= a.cin) continue;
        // D + sum in autograd's order; conv 4: g + sum in x's part, the sum alone elsewhere
        float v0 = acc[4 * j + 2 * hr], v1 = acc[4 * j + 2 * hr + 1];
        if (a.k < 4 || ci < a.ch) {
          v0 = __fadd_rn(dv[j][hr].x, v0);
          v1 = __fadd_rn(dv[j][hr].y, v1);
        }
        if (fin) {
          // D[out_k] is final: dy_{k-1} = slope * bf16(D), as the products take it
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&fv[j][hr]));
          v0 = round_bf16(v0);
          v1 = round_bf16(v1);
          v0 = f.x >= 0.f ? v0 : __fmul_rn(v0, 0.2f);
          v1 = f.y >= 0.f ? v1 : __fmul_rn(v1, 0.2f);
          *reinterpret_cast<__nv_bfloat162*>(a.DY + pix[hr] * cd + ci) = __floats2bfloat162_rn(v0, v1);
          db0 += v0;
          db1 += v1;
        } else if (a.k == 0) {
          *reinterpret_cast<__nv_bfloat162*>(a.dx + pix[hr] * a.ch + ci) = __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(a.D + pix[hr] * cd + ci) = make_float2(v0, v1);
        }
      }
      if (fin) {
        // the column sums over the warp's 8 pixel columns, then (below) its 4 warps in order
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          db0 += __shfl_xor_sync(0xffffffffu, db0, off);
          db1 += __shfl_xor_sync(0xffffffffu, db1, off);
        }
        if (g == 0) {
          s_db[warp * NW + 8 * j + 2 * tig] = db0;
          s_db[warp * NW + 8 * j + 2 * tig + 1] = db1;
        }
      }
    }
    if (any_fin) {
      wg_barrier(1 + wg);
      if (wt < NW && t < tiles) {
        const int ci = cw + wt;
        if (ci >= fin0 && ci < fin0 + gc && ci < a.cin)
          a.dbp[(size_t)t * gc + ci - fin0] =
              ((s_db[wt] + s_db[NW + wt]) + s_db[2 * NW + wt]) + s_db[3 * NW + wt];
      }
    }
  }
}

constexpr int dgrad_tf32_smem() {
  // dy hi, lo (8 channels of the halo) + weights (hi, lo: 2 x 4 x 9 x 8 x 8
  // floats); the epilogue's f32 tile reuses them
  return 16 * (HALO * 2 * 2 + 2 * (F32_NT / 8) * 9 * 8 * 2) > 4 * PIX * (F32_NT + 8)
             ? 16 * (HALO * 2 * 2 + 2 * (F32_NT / 8) * 9 * 8 * 2)
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

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * TH;
  const int n = blockIdx.z / a.ci_tiles, ci0 = (blockIdx.z % a.ci_tiles) * NT;
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
    // dy_k of the halo, 8 channels: 4 f32 a unit, zero outside the image
    for (int e = tid; e < A_UNITS; e += THREADS) {
      const int p = e >> 1, half = e & 1;
      const int gy = ty0 - 1 + p / SW, gx = tx0 - 1 + p % SW;
      const int co = c0 + half * 4;
      const bool ok = gy >= 0 && gy < a.h && gx >= 0 && gx < a.wd && co < a.cout;
      cp_async16(smem_u32(s_ah + unit2(p, half)),
                 ok ? a.DY + (img + (size_t)gy * a.wd + gx) * cd + dyo + co : a.DY, ok);
    }
    cp_async_commit();
    cp_async_wait0();
    asm volatile("" ::: "memory");
    // this thread's own copies have landed (the loop mirrors the copies'):
    // split them into TF32 hi (in place) and lo
    for (int e = tid; e < A_UNITS; e += THREADS) {
      const int u = unit2(e >> 1, e & 1);
      const uint4 v = s_ah[u];
      uint4 hi, lo;
      split_tf32(__uint_as_float(v.x), hi.x, lo.x);
      split_tf32(__uint_as_float(v.y), hi.y, lo.y);
      split_tf32(__uint_as_float(v.z), hi.z, lo.z);
      split_tf32(__uint_as_float(v.w), hi.w, lo.w);
      s_ah[u] = hi;
      s_al[u] = lo;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      // dsrc[q] = sum over taps of dy[q - tap + 1] W[tap]: halo shift s
      // reads W's tap 8 - s
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
    __syncthreads();
  }

  // the epilogue: the block's f32 sums through shared memory, [pixel][NT + 8]
  constexpr int OS = NT + 8;
  float* s_out = reinterpret_cast<float*>(smem);
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
  const int fin0 = a.k > 0 ? a.ch + (a.k - 1) * gc : cd;  // out_k's channels: D final here, dy_{k-1} out
  for (int e = tid; e < PIX * (NT / 8); e += THREADS) {
    const int px = e / (NT / 8), cg = e % (NT / 8);
    const int gy = ty0 + px / TW, gx = tx0 + px % TW;
    const int ci = ci0 + cg * 8;
    const bool fin = ci >= fin0 && ci < fin0 + gc;
    float v[8], d[8];
    if (gy >= a.h || gx >= a.wd || ci >= a.cin) {
      if (fin) {  // no pixel: nothing in the db sums
#pragma unroll
        for (int o = 0; o < 8; ++o) v[o] = 0.f;
        storen(s_out + px * OS + cg * 8, v, 8);
      }
      continue;
    }
    loadn(s_out + px * OS + cg * 8, v, 8);
    const size_t pix = img + (size_t)gy * a.wd + gx;
    if (a.k == 4) {
      if (ci < a.ch) {  // D = g + c_4 in x's part (autograd's order: g arrives first)
        loadn(a.g + pix * a.ch + ci, d, 8);
#pragma unroll
        for (int o = 0; o < 8; ++o) v[o] = __fadd_rn(d[o], v[o]);
      }
    } else {
      loadn(a.D + pix * cd + ci, d, 8);
#pragma unroll
      for (int o = 0; o < 8; ++o) v[o] = __fadd_rn(d[o], v[o]);
    }
    if (fin) {
      // D[out_k] is final: dy_{k-1} = slope * D, and its value for the db sums
      loadn(a.feat + pix * a.fc + ci - a.ch, d, 8);
#pragma unroll
      for (int o = 0; o < 8; ++o) v[o] = d[o] >= 0.f ? v[o] : __fmul_rn(v[o], 0.2f);
      storen(a.DY + pix * cd + ci, v, 8);
      storen(s_out + px * OS + cg * 8, v, 8);
    } else if (a.k == 0) {
      storen(a.dx + pix * a.ch + ci, v, 8);  // dx, rounded once
    } else {
      storen(a.D + pix * cd + ci, v, 8);
    }
  }
  if (a.k == 0 || ci0 + NT <= fin0 || ci0 >= fin0 + gc) return;
  __syncthreads();
  // db_{k-1}'s tile partial: 4 threads a channel, 32 pixels each, then in order
  const int c = tid >> 2, q = tid & 3;
  float s = 0.f;
  for (int px = q * (PIX / 4); px < (q + 1) * (PIX / 4); ++px) s += s_out[px * OS + c];
  const float s1 = __shfl_down_sync(0xffffffffu, s, 1), s2 = __shfl_down_sync(0xffffffffu, s, 2),
              s3 = __shfl_down_sync(0xffffffffu, s, 3);
  const int ci = ci0 + c;
  if (q == 0 && ci >= fin0 && ci < fin0 + gc && ci < a.cin)
    a.dbp[(size_t)tile * gc + ci - fin0] = ((s + s1) + s2) + s3;
}

// ---- wgrad -------------------------------------------------------------

struct WgradWgArgs {
  const bf16* x;     // (P, ch)
  const bf16* feat;  // (P, fc)
  const bf16* DY;    // (P, cd)
  float* part;       // (slices, E) f32: each slice's dW partials, the convs' HWIO in order
  int n, h, wd, ch, fc, slices, tiles_y, tiles_x;
  long long elems;   // E
  long long off[5];  // conv k's first element in a slice's partials
  unsigned short job_src[MAX_JOBS], job_dy[MAX_JOBS];  // a job's first source and DY channel
};

// bf16 wgrad of every conv: job blockIdx.x, pixel slice blockIdx.y. With
// TMA (ch and fc multiples of 64: a job's 64 source channels lie wholly in
// x or in feat) one thread copies a tile's source halo and DY as two
// tensor-map boxes, 128-byte swizzled, zeros past the image, completing on
// the stage's mbarrier; else every thread copies 16-byte units (cp.async)
template <bool TMA>
__global__ void __launch_bounds__(WW_THREADS, 1)
    wgrad_wgmma_kernel(const WgradWgArgs a, const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_feat, const __grid_constant__ CUtensorMap map_dy) {
  extern __shared__ __align__(128) uint8_t sm8[];
  constexpr int STAGE = WS_BYTES + WD_BYTES;
  uint8_t* sm = align1024(sm8);  // the swizzled buffers start 1024-byte aligned
  const uint32_t bar0 = smem_u32(sm + WSTAGES * STAGE);  // the stages' mbarriers (TMA), 8 bytes each
  const int src0 = a.job_src[blockIdx.x], dy0 = a.job_dy[blockIdx.x];
  const int s = blockIdx.y;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
  const int cd = a.ch + a.fc, gc = a.fc / 4;
  const int tiles = a.n * a.tiles_y * a.tiles_x;
  const int count = s < tiles ? (tiles - s + a.slices - 1) / a.slices : 0;

  // tile i of the slice: its source halo [8][halo pixel][8 channels] and DY
  // [8][pixel][8 channels], zero outside, into ring slot i % WSTAGES; one
  // commit group, empty past the slice
  auto stage = [&](int i) {
    if constexpr (TMA) {
      if (tid == 0 && i < count) {
        const int t = s + i * a.slices, per = a.tiles_y * a.tiles_x;
        const int ty0 = (t % per) / a.tiles_x * BT, tx0 = (t % per) % a.tiles_x * BT;
        const uint32_t ss = smem_u32(sm + (i % WSTAGES) * STAGE), bar = bar0 + (i % WSTAGES) * 8;
        mbar_expect_tx(bar, (BHP + BPIX) * WC * 2);
        if (src0 < a.ch)
          tma_load4(ss, &map_x, bar, src0, tx0 - 1, ty0 - 1, t / per);
        else
          tma_load4(ss, &map_feat, bar, src0 - a.ch, tx0 - 1, ty0 - 1, t / per);
        tma_load4(ss + WS_BYTES, &map_dy, bar, dy0, tx0, ty0, t / per);
      }
      return;
    }
    if (i < count) {
      int ty0, tx0;
      size_t img;
      tile_origin(s + i * a.slices, a.tiles_y, a.tiles_x, BT, BT, a.h, a.wd, ty0, tx0, img);
      uint8_t* ss = sm + (i % WSTAGES) * STAGE;
      uint8_t* sd = ss + WS_BYTES;
      for (int e = tid; e < BHP * 8; e += WW_THREADS) {
        const int p = e >> 3, c8 = e & 7;
        const int gy = ty0 - 1 + p / BH, gx = tx0 - 1 + p % BH;
        const int c = src0 + c8 * 8;  // ch % 8 == 0: 8 channels lie wholly in x or in feat
        const bool ok = gy >= 0 && gy < a.h && gx >= 0 && gx < a.wd && c < cd;
        const bf16* src = a.x;
        if (ok) {
          const size_t pix = img + (size_t)gy * a.wd + gx;
          src = c < a.ch ? a.x + pix * a.ch + c : a.feat + pix * a.fc + (c - a.ch);
        }
        cp_async16(smem_u32(ss + swz_off(p, c8)), src, ok);
      }
      for (int e = tid; e < BPIX * 8; e += WW_THREADS) {
        const int p = e >> 3, c8 = e & 7;
        const int gy = ty0 + p / BT, gx = tx0 + p % BT;
        const int c = dy0 + c8 * 8;
        const bool ok = gy < a.h && gx < a.wd && c < cd;
        cp_async16(smem_u32(sd + swz_off(p, c8)),
                   ok ? a.DY + (img + (size_t)gy * a.wd + gx) * cd + c : a.DY, ok);
      }
    }
    cp_async_commit();
  };

  float acc[3][32];
#pragma unroll
  for (int sx = 0; sx < 3; ++sx)
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[sx][q] = 0.f;

  // tile i's products are queued while tile i - 1's run; the slot of tile
  // i - 2, done in every warp by the barrier, takes tile i + WSTAGES - 2
  if constexpr (TMA) {
    if (tid == 0) {
      prefetch_tensormap(src0 < a.ch ? &map_x : &map_feat);
      prefetch_tensormap(&map_dy);
      for (int q = 0; q < WSTAGES; ++q) mbar_init(bar0 + q * 8);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  for (int i = 0; i < WSTAGES - 2; ++i) stage(i);
  for (int i = 0; i < count; ++i) {
    if constexpr (TMA) {
      mbar_wait(bar0 + (i % WSTAGES) * 8, (i / WSTAGES) & 1);  // tile i's boxes
    } else {
      cp_async_wait<WSTAGES - 3>();  // tile i's copies; younger ones may fly
      fence_async_smem();
    }
    __syncthreads();
    stage(i + WSTAGES - 2);
    const uint32_t sb = smem_u32(sm + (i % WSTAGES) * STAGE), sd = sb + WS_BYTES;
    wgmma_fence();
#pragma unroll
    for (int r = 0; r < BT / 2; ++r) {
      // K = 16 pixels, tile rows 2r and 2r + 1; A = the source at tap (wg, sx), B = dy
      // (both operands 128-byte swizzled rows, a row a pixel: MN-major, K in 8-row groups)
      const uint64_t db = smem_desc(sd + r * 16 * 128, 16, 8 * 128, SW128);
#pragma unroll
      for (int sx = 0; sx < 3; ++sx)
        wgmma<64, 1, 1>(acc[sx], smem_desc(sb + ((2 * r + wg) * BH + sx) * 128, 16, BH * 128, SW128), db, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // tile i - 1's products
  }
  wgmma_wait0();

  // this slice's partials: rows are source channels, columns DY channels
  float* base = a.part + (size_t)s * a.elems;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = dy0 + 8 * j + 2 * tig;  // a DY channel: conv 4's below ch, else conv (c - ch) / gc's
    if (c >= cd) continue;
    const int k = c < a.ch ? 4 : (c - a.ch) / gc;
    const int co = c < a.ch ? c : (c - a.ch) % gc;
    const int cin = a.ch + k * gc, cout = k < 4 ? gc : a.ch;
#pragma unroll
    for (int sx = 0; sx < 3; ++sx)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int ci = src0 + 16 * warp + g + 8 * hr;
        if (ci < cin)
          *reinterpret_cast<float2*>(base + a.off[k] + ((size_t)(wg * 3 + sx) * cin + ci) * cout + co) =
              make_float2(acc[sx][4 * j + 2 * hr], acc[sx][4 * j + 2 * hr + 1]);
      }
  }
}

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

// job j of the f32 launch: convs conv_hi down to conv_lo, each in (32 input x
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

// f32 wgrad (3xTF32): a block takes one (conv, 32 input channels, 32 output
// channels) job and one of S pixel slices (every S-th 16x8 tile), six warps
// (a warp = one tap row, 16 input channels); 32-bit loads from rows padded to
// 40 floats (no bank conflicts)
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
    tile_origin(s + i * a.slices, a.tiles_y, a.tiles_x, TH, TW, a.h, a.wd, ty0, tx0, img);
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

// out[e] for e < E: dW, the S slices' partials summed in slice order, 16
// read at once (rounded to bf16 for a bf16 block), a thread an element;
// after them each conv's db, a warp a channel: lane l sums tiles l, l + 32,
// .. in order, then the lanes in a fixed tree
constexpr int REDUCE_THREADS = 256;

__global__ void __launch_bounds__(REDUCE_THREADS) reduce_kernel(const float* part, int slices, long long elems,
                                                                const float* dbp, int tiles, int ch, int gc,
                                                                float* out, int bf16_sums, int dw_blocks) {
  if ((int)blockIdx.x < dw_blocks) {
    const long long e = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
    if (e >= elems) return;
    float s = 0.f;
    for (int i0 = 0; i0 < slices; i0 += 16) {
      float v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = i0 + i < slices ? part[(size_t)(i0 + i) * elems + e] : 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (i0 + i < slices) s += v[i];
    }
    out[e] = bf16_sums ? round_bf16(s) : s;
    return;
  }
  const int lane = threadIdx.x & 31;
  int b = ((int)blockIdx.x - dw_blocks) * (REDUCE_THREADS / 32) + (threadIdx.x >> 5);
  long long doff = 0;
  for (int k = 0; k < 5; ++k) {
    const int cout = k < 4 ? gc : ch;
    if (b < cout) {
      float s = 0.f;
      for (int t0 = 0; t0 < tiles; t0 += 32 * 8) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = t0 + 32 * i + lane;
          v[i] = t < tiles ? dbp[doff + (size_t)t * cout + b] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (t0 + 32 * i + lane < tiles) s += v[i];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) out[elems + (doff / tiles) + b] = s;  // doff / tiles: the couts before conv k
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

// the bf16 wgrad's jobs: (64 source, 64 DY channel) pairs that some conv
// reads, in (source, DY) order; the same rule as ops/cuda/rdb.py's
int wgrad_jobs(int ch, int gc, unsigned short* src, unsigned short* dy) {
  const int cd = ch + 4 * gc;
  int jobs = 0;
  for (int a = 0; a < cd; a += WC)
    for (int b = 0; b < cd; b += WC) {
      int widest = 0;  // the largest cin among the convs of DY channels [b, b + 64)
      for (int c = b; c < b + WC && c < cd; c += 8) {
        const int k = c < ch ? 4 : (c - ch) / gc;
        widest = widest > ch + k * gc ? widest : ch + k * gc;
      }
      if (widest <= a) continue;
      if (jobs == MAX_JOBS) return -1;
      src[jobs] = (unsigned short)a;
      dy[jobs] = (unsigned short)b;
      ++jobs;
    }
  return jobs;
}

// A tensor map of `base`, bf16 (n, h, wd, c) channels-last, boxes of box_c
// (32 or 64) channels x side x side pixels x 1 image, 64- or 128-byte
// swizzled (a box row's bytes), zeros out of bounds; cuTensorMapEncodeTiled
// taken once from the runtime. 0, or a cudaError_t / CUresult code.
int encode_box(CUtensorMap* map, const void* base, int c, int wd, int h, int n, int side, int box_c = WC) {
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
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)wd * c * 2, (cuuint64_t)h * wd * c * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)side, (cuuint32_t)side, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            box_c * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return (int)r;
}

template <int NT, bool TMA>
cudaError_t launch_dgrad_wgmma(const DgradArgs<bf16>& a, const CUtensorMap& map, int sms, cudaStream_t stream) {
  const int smem = DgradSmem(NT, a.cout).total;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  static const cudaError_t attr =
      cudaFuncSetAttribute(dgrad_wgmma_kernel<NT, TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  // blocks a multiprocessor holds at this shared memory, asked once per size
  static int cached_smem[2] = {-1, -1}, cached_per_sm[2] = {0, 0};
  const int c = cached_smem[0] == smem ? 0 : cached_smem[1] == smem ? 1 : cached_smem[0] < 0 ? 0 : 1;
  if (cached_smem[c] != smem) {
    const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached_per_sm[c], dgrad_wgmma_kernel<NT, TMA>, DG_THREADS, smem);
    if (occ != cudaSuccess) return occ;
    cached_smem[c] = smem;
  }
  const int per_sm = cached_per_sm[c];
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int steps = (a.n * a.tiles_y * a.tiles_x + 4 / dgrad_wg_per_tile(NT) - 1) / (4 / dgrad_wg_per_tile(NT));
  int groups = steps;  // blocks for one channel part
  const int room = per_sm * sms / a.ci_tiles;
  if (groups > room) groups = room > 0 ? room : 1;
  dgrad_wgmma_kernel<NT, TMA><<<groups * a.ci_tiles, DG_THREADS, smem, stream>>>(a, map);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_dgrad_wgmma(const DgradArgs<bf16>& a, int sms, cudaStream_t stream) {
  CUtensorMap map = {};
  if (a.cout != 32 && a.cout != 64) return launch_dgrad_wgmma<NT, false>(a, map, sms, stream);
  const int err = encode_box(&map, a.DY, a.ch + a.fc, a.wd, a.h, a.n, BH, a.cout);
  if (err) return (cudaError_t)err;
  return launch_dgrad_wgmma<NT, true>(a, map, sms, stream);
}

template <typename T>
int run_backward(const T* x, const T* feat, const T* g, const T* w, float* D, T* DY, float* part, float* dbp,
                 float* out, T* dx, int n, int h, int wd, int ch, int gc, int want_dx, int slices, int sms, int only,
                 cudaStream_t stream) {
  constexpr bool BF = sizeof(T) == 2;
  const int fc = 4 * gc, cd = ch + fc;
  const int th = BF ? BT : TH, tw = BF ? BT : TW;
  const int tiles_x = (wd + tw - 1) / tw, tiles_y = (h + th - 1) / th;
  const int tiles = n * tiles_x * tiles_y;
  long long elems = 0, off[5];
  int n_bias = 0;
  size_t woff[5], dboff[5];
  {
    size_t wo = 0, dbo = 0;
    for (int k = 0; k < 5; ++k) {
      const int cin = ch + k * gc, cout = k < 4 ? gc : ch;
      woff[k] = wo;
      dboff[k] = dbo;
      off[k] = elems;
      wo += packed_numel(cin, cout, BF);
      dbo += (size_t)tiles * cout;
      elems += 9LL * cin * cout;
      n_bias += cout;
    }
  }
  // dy_4, then the input gradients from conv 4 down to 0 (conv 0's only for
  // dx): in f32 a dgrad launch a conv, in bf16 a launch a target group
  // (out_4 .. out_1, then x)
  for (int k = 4; k >= 0; --k) {
    if ((only >= 0 && only != k) || (k == 0 && !want_dx)) continue;
    if (k == 4) {
      dy4_kernel<T><<<tiles, ch < 128 ? ch : 128, 0, stream>>>(g, DY, dbp + dboff[4], h, wd, ch, cd, th, tiles_y,
                                                               tiles_x);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    cudaError_t err;
    if constexpr (BF) {
      // one pass over cin where its weights fit, else halves (conv 4 at ch 64, gc 32)
      const int cin = ch + k * gc, cout = k < 4 ? gc : ch;
      DgradArgs<T> a{DY, g, feat, D, k > 0 ? dbp + dboff[k - 1] : dbp, w + woff[k], dx, n, h, wd, ch, fc, cin,
                     cout, k, tiles_y, tiles_x, 1};
      int parts = (cin + 159) / 160, nt = 0;
      for (;; ++parts) {
        nt = ((cin + parts - 1) / parts + 31) / 32 * 32;
        if (nt <= 32 || DgradSmem(nt, cout).total <= SMEM_MAX) break;
      }
      a.ci_tiles = parts;
      switch (nt) {
        case 32: err = launch_dgrad_wgmma<32>(a, sms, stream); break;
        case 64: err = launch_dgrad_wgmma<64>(a, sms, stream); break;
        case 96: err = launch_dgrad_wgmma<96>(a, sms, stream); break;
        case 128: err = launch_dgrad_wgmma<128>(a, sms, stream); break;
        case 160: err = launch_dgrad_wgmma<160>(a, sms, stream); break;
        default: return -1;
      }
    } else {
      const int cin = ch + k * gc, cout = k < 4 ? gc : ch;
      DgradArgs<T> a{DY, g, feat, D, k > 0 ? dbp + dboff[k - 1] : dbp, w + woff[k], dx, n, h, wd, ch, fc, cin,
                     cout, k, tiles_y, tiles_x, (cin + F32_NT - 1) / F32_NT};
      dgrad_tf32_kernel<<<dim3(tiles_x, tiles_y, n * a.ci_tiles), THREADS, dgrad_tf32_smem(), stream>>>(a);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return (int)err;
  }
  // wgrad of every conv in one launch
  if (only < 0 || only == 5) {
    if constexpr (BF) {
      WgradWgArgs a{x, feat, DY, part, n, h, wd, ch, fc, slices, tiles_y, tiles_x, elems, {}, {}, {}};
      for (int k = 0; k < 5; ++k) a.off[k] = off[k];
      const int jobs = wgrad_jobs(ch, gc, a.job_src, a.job_dy);
      if (jobs <= 0) return -1;
      // 1024: the base's alignment; 64: the stages' mbarriers
      constexpr int smem = 1024 + WSTAGES * (WS_BYTES + WD_BYTES) + 64;
      CUtensorMap maps[3] = {};
      const bool tma = ch % WC == 0 && fc % WC == 0;
      if (tma) {
        const int e1 = encode_box(&maps[0], x, ch, wd, h, n, BH), e2 = encode_box(&maps[1], feat, fc, wd, h, n, BH),
                  e3 = encode_box(&maps[2], DY, cd, wd, h, n, BT);
        if (e1 || e2 || e3) return e1 ? e1 : e2 ? e2 : e3;
      }
      static const cudaError_t attr0 =
          cudaFuncSetAttribute(wgrad_wgmma_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      static const cudaError_t attr1 =
          cudaFuncSetAttribute(wgrad_wgmma_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (attr0 != cudaSuccess || attr1 != cudaSuccess) return (int)(attr0 != cudaSuccess ? attr0 : attr1);
      if (tma)
        wgrad_wgmma_kernel<true><<<dim3(jobs, slices), WW_THREADS, smem, stream>>>(a, maps[0], maps[1], maps[2]);
      else
        wgrad_wgmma_kernel<false><<<dim3(jobs, slices), WW_THREADS, smem, stream>>>(a, maps[0], maps[1], maps[2]);
    } else {
      int jobs = 0;
      for (int k = 0; k < 5; ++k) {
        const int cin = ch + k * gc, cout = k < 4 ? gc : ch;
        jobs += ((cin + WCI - 1) / WCI) * ((cout + WCO - 1) / WCO);
      }
      WgradArgs<T> a{x, feat, DY, part, n, h, wd, ch, fc, slices, tiles_y, tiles_x, 0, 4, elems};
      // above 48 KB only as opted-in dynamic shared memory; once
      static const cudaError_t attr = cudaFuncSetAttribute(
          wgrad_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wgrad_tf32_smem());
      if (attr != cudaSuccess) return (int)attr;
      wgrad_tf32_kernel<<<dim3(jobs, slices), WG_THREADS, wgrad_tf32_smem(), stream>>>(a);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (only < 0 || only == 6) {
    const int dw_blocks = (int)((elems + REDUCE_THREADS - 1) / REDUCE_THREADS);
    const int db_blocks = (n_bias + REDUCE_THREADS / 32 - 1) / (REDUCE_THREADS / 32);
    reduce_kernel<<<dw_blocks + db_blocks, REDUCE_THREADS, 0, stream>>>(part, slices, elems, dbp, tiles, ch, gc,
                                                                       out, BF ? 1 : 0, dw_blocks);
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
// dbp (tiles, sum of the couts) f32, tiles of 8x8 pixels in bf16 and 16x8 in
// f32; out (E + sum of the couts) f32: the five dW in HWIO, then the five
// db; dx (N, H, W, ch) in x's dtype unless !want_dx. `sms` is the card's
// multiprocessor count. `only` = -1 runs every launch; 0-4 one conv's dgrad
// (4 with dy_4's pass), 5 the wgrad, 6 the sums (for timing them apart).
// Returns 0, the cudaGetLastError() code of the first failed launch, or -1
// for arguments the kernels do not take. Launches on `stream`; does not
// synchronise.
extern "C" int rdb_backward_cuda(const void* x, const void* feat, const void* g, const void* w, float* D, void* DY,
                                 float* part, float* dbp, float* out, void* dx, int n, int h, int wd, int ch, int gc,
                                 int dtype, int want_dx, int slices, int sms, int only, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || ch <= 0 || gc <= 0 || ch % 8 || gc % 8 || slices <= 0 || sms <= 0) return -1;
  if (only < -1 || only > 6) return -1;
  const int widest = ch + 4 * gc;
  if ((h + TH - 1) / TH > 65535 || (long long)n * ((widest + 31) / 32) > 65535 || slices > 65535) return -1;
  if (widest > 65535 - WC) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_backward<float>(static_cast<const float*>(x), static_cast<const float*>(feat),
                               static_cast<const float*>(g), static_cast<const float*>(w), D,
                               static_cast<float*>(DY), part, dbp, out, static_cast<float*>(dx), n, h, wd, ch, gc,
                               want_dx, slices, sms, only, s);
  if (dtype == 1)
    return run_backward<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(feat),
                              static_cast<const bf16*>(g), static_cast<const bf16*>(w), D, static_cast<bf16*>(DY),
                              part, dbp, out, static_cast<bf16*>(dx), n, h, wd, ch, gc, want_dx, slices, sms, only,
                              s);
  return -1;
}

extern "C" const char* rdb_backward_error_string(int code) {
  return code < 0 ? "argument not supported by the kernel"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}
