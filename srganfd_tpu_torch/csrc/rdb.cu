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
// on the tensor cores:
//
// bf16, `conv3x3_wgmma_kernel<LAST, TMA>`: each launch is an implicit GEMM,
// M = an 8x8 output pixel tile (one wgmma M of 64), N = a tile of 32 couts
// (conv 4's 64 couts in two: its 192 x 64 x 9 weights, 221 KB, leave no
// room for a halo beside them, where a half's 110,592 bytes leave three),
// K = 9 taps x cin. Persistent blocks, about one a multiprocessor, each on
// one cout tile and every S-th pixel tile, copy the conv's weights once from
// the packed [cin/16][tap][cout][16] layout (`pack_rdb_weights`, which the
// backward and the exported custom op read too) into [step][tap][k half]
// [cout / 8] core matrices, a K-major B. A producer warp fills a ring of up
// to four halo slots, each a tile's 10x10 halo of all cin channels: where
// ch is a multiple of 64 and gc of 16 (every recipe), one thread asks for
// tensor-map boxes of 64 channels x 10 x 10 pixels, x's channels from one
// map and feat's from the other (the virtual concat), 128-byte swizzled
// rows of one pixel, zeros past the image, completing on the slot's
// mbarrier; else the warp copies 16-byte units with cp.async into [cin /
// 8][halo pixel][8] core matrices, zeros past the image and past cin (a
// half-filled 16-channel step is zero in the input and the packed
// weights). Three consumer warpgroups take the filled slots in turn: per
// 16-channel step and tap one wgmma.m64n32k16 (bf16 in, f32 accumulate)
// whose A descriptor is the tap's shifted window of the halo (a tile row is
// 8 consecutive halo rows, one tile row to the next a halo row of 10: no
// im2col copy, no ldmatrix), then release the slot and run the epilogue
// from the accumulator registers while the other warpgroups' products run:
// bias, LeakyReLU(0.2) or `* 0.2 + x` in f32, rounded to bf16 once, two
// channels a store. Each launch is a programmatic dependent of the one
// before: its blocks copy their weights while the last blocks of the
// launch before finish, and wait (griddepcontrol.wait) before they read a
// pixel of it.
//
// f32, `conv3x3_tf32_kernel` (split-precision 3xTF32, mma.sync): an
// implicit GEMM, M = the block's 16x8 output pixels (4 warps of 4 rows x 8
// columns), N = cout tiles of 16 or 32, K = 9 x cin in 8-channel steps of
// mma.sync.m16n8k8 (TF32 in, f32 accumulate). Per step the block stages
// its 18x10 halo tile and the matching weights by 16-byte cp.async into
// double-buffered shared memory, rows XOR-swizzled so that each 8x16-byte
// ldmatrix phase hits 32 distinct banks; a tap's A fragment is one
// ldmatrix from the shifted window (no im2col copy): an 8x8 b16 matrix
// whose 16-byte rows hold 4 f32 channels lands in the TF32 A layout (row =
// lane / 4, column = lane % 4), and likewise for B. TF32 keeps 10
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
// f32 after the step. The epilogue stages acc + bias in f32 through shared
// memory and writes 8 channels a store.
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
// What the bf16 design leaves, as its clock64 counters read on the card
// (`rdb_bwd_study.py --mode probe`; PERF.md §6): a tile's products run near
// the rate at which shared memory feeds m64n32k16 (2 KB of A and 1 KB of B a
// wgmma, against 16 cycles of products), three warpgroups sharing the tensor
// cores; the rest of the gap is at the launches' joints. Each conv waits for
// the one before to finish, then for its first halos; a block copies its 37
// to 111 KB of weights in ~10,000 cycles (all blocks read the same lines),
// hidden only where the launch before leaves its multiprocessor early; the
// tiles of a block differ by one; conv 4 reads each halo twice (two cout
// blocks of 32).
//
// f32: three TF32 products per pair, 3 * 3.14e10 FLOP, 190 us at the
// H100's 495 TFLOP/s dense TF32 peak (469 us for one product each at the
// CUDA cores' 67 TFLOP/s f32 peak). Per 8-channel step a block stages its
// hi and lo weights, 4 bytes and two halves per weight, so the weights' L2
// traffic weighs more than in bf16.

#include <cuda.h>  // CUtensorMap and its enums (the encoder is taken from the runtime at first use)
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

// ---- shared helpers -----------------------------------------------------

constexpr int M_TW = 8;                // the f32 kernel's tile columns: one ldmatrix row of pixels
constexpr int M_SW = M_TW + 2;         // its staged columns (one-pixel halo)

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

// Unit `half` (channels 0-7 or 8-15) of row r (a staged pixel, or a
// (tap, cout) weight row) of 32 bytes: XOR-swizzled so that 8 consecutive
// rows at one half fall into 8 distinct 16-byte bank groups.
__device__ __forceinline__ int unit2(int r, int half) { return r * 2 + (half ^ ((r >> 2) & 1)); }

// ---- bf16: wgmma fed by the tensor memory accelerator ---------------------

using bf16 = __nv_bfloat16;

constexpr int BT = 8;                          // tile side: 64 output pixels, one wgmma M
constexpr int BH = BT + 2;                     // halo side
constexpr int BHP = BH * BH;                   // halo pixels
constexpr int FN = 32;                         // the wgmma N: a block's tile of couts
constexpr int CONSUMERS = 3;                   // warpgroups on the products, a pixel tile each
constexpr int W_THREADS = 128 * CONSUMERS + 32;  // and one producer warp
constexpr int BOX_C = 64;                      // channels a tensor-map box: one 128-byte row a pixel
constexpr int BOX_BYTES = BHP * BOX_C * 2;     // a box as TMA writes it
constexpr int BOX_SLOT = (BOX_BYTES + 1023) & ~1023;  // its place in a ring slot, 1024-byte aligned
constexpr int W_TAP = FN * 16 * 2;             // one (16-channel step, tap)'s weights: 32 couts x 16
constexpr int SMEM_MAX = 232448;               // a block's shared memory on the H100

// The bf16 kernel's shared memory for conv k (cin input channels, a ring of
// `ring` halo slots), in bytes: one slot holds a tile's 10x10 halo of all
// cin channels (TMA: ceil(cin / 64) boxes of 64 channels; cp.async: [cin /
// 8][halo pixel][8 channels]); then the block's weights, and two mbarriers
// a slot. ops/cuda/rdb.py's `_fwd_plan` mirrors this: change both.
struct FwdSmem {
  int halo, w, total;
  __host__ __device__ FwdSmem(int ch, int cin, int ring, bool tma) {
    const int steps = (cin + 15) / 16;
    halo = tma ? (ch / BOX_C + (cin - ch + BOX_C - 1) / BOX_C) * BOX_SLOT : (steps * 2 * BHP * 16 + 1023) & ~1023;
    w = steps * 9 * W_TAP;
    total = 1024 + ring * halo + w + 16 * ring;  // 1024: the base's alignment
  }
};

// A shared-memory matrix descriptor: `lbo` the byte stride between core
// matrices (8 rows of 16 bytes) along K, `sbo` along M or N; layout 0 is
// no swizzle (a core matrix 128 contiguous bytes), 1 the 128-byte swizzle
// (rows of 128 bytes, the 16-byte chunk c of row r at c ^ (r % 8), the XOR
// taken on the address bits: the buffer starts 1024-byte aligned and a
// descriptor may start at any row)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t layout = 0) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)layout << 62);
}
constexpr uint32_t SW128 = 1;
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// shared memory written through the generic proxy (cp.async), then read by wgmma
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma's issue and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 32 f32) = A (64 x 16 bf16) * B (16 x 32 bf16) (+ d where acc != 0),
// both K-major from shared memory. The warpgroup's thread t holds rows 16 (t
// / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1): d[4 j + {0,
// 1}] and, 8 rows on, d[4 j + {2, 3}].
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
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
// an arrive on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n@P1 bra DONE;\nbra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// a 4-d box (channels, x, y, image) of `map` into shared memory, completing
// on `bar`; the halo past the image reads as zero
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c, int x, int y,
                                          int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(x), "r"(y), "r"(n)
      : "memory");
}

#ifdef SRGANFD_PROBE
// clock64 phase counters, summed over every consumer warpgroup and tile of
// the launches since the last read: [0] waiting for a tile's halo, [1] its
// products (issue to wait), [2] its epilogue, [3] tiles, [4] the producer
// waiting for a free slot; per block [5] its start to its weights' landing,
// [6] from there to the launch before it being complete (griddepcontrol.wait),
// [7] blocks
__device__ unsigned long long probe_sums[8];
#define PROBE(...) __VA_ARGS__
#else
#define PROBE(...)
#endif

struct ConvArgs {
  const bf16* x;      // (N, H, W, ch)
  const bf16* feat;   // (N, H, W, fc): out_1 .. out_4
  const bf16* w;      // this conv's packed [cin/16][tap][cout_pad][16]
  const float* bias;  // (cout)
  bf16* out;          // feat (convs 0-3) or the block's output (conv 4)
  int n, h, wd, ch, fc, cin, cout, out_off, co_tiles, tiles_y, tiles_x, ring;
};

// One 3x3 'same' conv of the virtual concat [x (ch) | feat (fc)] over its
// first `cin` channels: persistent blocks, each on output channels [co0,
// co0 + 32) and every `stride`-th 8x8 pixel tile. The block copies its
// weights once into shared memory, [step][tap][k half][cout / 8] core
// matrices (a K-major B). A producer warp fills a ring of halo slots: with
// TMA (ch a multiple of 64, gc of 16) one thread copies a tile's 10x10 halo
// as tensor-map boxes of 64 channels, 128-byte swizzled rows of one pixel,
// zeros past the image, completing on the slot's mbarrier; else the warp
// copies 16-byte units (cp.async) into [cin / 8][halo pixel][8] core
// matrices, zeros past the image and cin. Three consumer warpgroups take the
// filled slots in turn: per 16-channel step and tap one m64n32k16 wgmma
// whose A descriptor is the tap's shifted window of the halo (one halo row
// a tile row: no im2col copy), then the epilogue from the accumulator
// registers while the other warpgroups' products run.
// LAST = false: out = feat, writes lrelu(conv + b) at channel offset out_off.
// LAST = true:  out (N, H, W, ch) = (conv + b) * 0.2 + x.
template <bool LAST, bool TMA>
__global__ void __launch_bounds__(W_THREADS, 1)
    conv3x3_wgmma_kernel(const ConvArgs a, const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_f) {
  extern __shared__ __align__(128) uint8_t sm8[];
  const FwdSmem L(a.ch, a.cin, a.ring, TMA);
  uint8_t* s_h = align1024(sm8);  // the ring: the swizzled halos start 1024-byte aligned
  uint8_t* s_w = s_h + a.ring * L.halo;
  const uint32_t full0 = smem_u32(s_w + L.w), empty0 = full0 + 8 * a.ring;
  // the warp index through a shuffle, so that ptxas sees it warp-uniform: a
  // wgmma under a branch it cannot prove uniform is serialised
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int steps = (a.cin + 15) / 16, cout_pad = (a.cout + 15) & ~15;
  const int co0 = (blockIdx.x % a.co_tiles) * FN;
  const int first = blockIdx.x / a.co_tiles, stride = gridDim.x / a.co_tiles;
  const int per = a.tiles_y * a.tiles_x, tiles = a.n * per;
  const int count = first < tiles ? (tiles - first + stride - 1) / stride : 0;  // this block's tiles

  // the next launch's blocks may take a multiprocessor as this grid's leave
  // it, and load their weights under this grid's tail (programmatic
  // dependent launch; they wait below before reading this launch's output)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  PROBE(const long long b0 = clock64());
  // the block's weights: 16-byte unit (step, tap, cout, k half) at core
  // matrix (step, tap, k half, cout / 8), row cout % 8; couts past the
  // packed ones read zero
  for (int e = tid; e < steps * 9 * FN * 2; e += W_THREADS) {
    const int kh = e & 1, r = e >> 1, co = r % FN, st = r / FN;  // st = step * 9 + tap
    const bool ok = co0 + co < cout_pad;
    cp_async16(smem_u32(s_w + st * W_TAP + kh * (W_TAP / 2) + (co >> 3) * 128 + (co & 7) * 16),
               ok ? a.w + ((size_t)st * cout_pad + co0 + co) * 16 + kh * 8 : a.w, ok);
  }
  cp_async_commit();
  if (tid == 0) {
    for (int q = 0; q < a.ring; ++q) {
      mbar_init(full0 + 8 * q, TMA ? 1 : 32);  // the producer's arrive (TMA) or its 32 lanes' (cp.async)
      mbar_init(empty0 + 8 * q, 4);            // the consuming warpgroup's 4 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (TMA) {
      prefetch_tensormap(&map_x);
      prefetch_tensormap(&map_f);
    }
  }
  cp_async_wait0();
  fence_async_smem();
  __syncthreads();
  // the previous launch (conv k - 1 writing this conv's last input channels,
  // or whatever wrote x) is complete and visible from here on
  PROBE(const long long b1 = clock64());
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  PROBE(if (tid == 0) {
    atomicAdd(&probe_sums[5], (unsigned long long)(b1 - b0));
    atomicAdd(&probe_sums[6], (unsigned long long)(clock64() - b1));
    atomicAdd(&probe_sums[7], 1ull);
  });

  if (warp == 4 * CONSUMERS) {  // the producer
    if (TMA && lane != 0) return;
    const int xb = a.ch / BOX_C, boxes = xb + (a.cin - a.ch + BOX_C - 1) / BOX_C;
    PROBE(long long waited = 0);
    for (int i = 0; i < count; ++i) {
      const int slot = i % a.ring;
      PROBE(const long long c0 = clock64());
      if (i >= a.ring) mbar_wait(empty0 + 8 * slot, (i / a.ring - 1) & 1);
      PROBE(waited += clock64() - c0);
      const int t = first + i * stride, img = t / per;
      const int ty0 = (t % per) / a.tiles_x * BT, tx0 = (t % per) % a.tiles_x * BT;
      uint8_t* dst = s_h + slot * L.halo;
      const uint32_t full = full0 + 8 * slot;
      if constexpr (TMA) {
        mbar_expect_tx(full, boxes * BOX_BYTES);
        for (int b = 0; b < boxes; ++b)
          tma_load4(smem_u32(dst + b * BOX_SLOT), b < xb ? &map_x : &map_f, full, (b < xb ? b : b - xb) * BOX_C,
                    tx0 - 1, ty0 - 1, img);
      } else {
        const size_t base = (size_t)img * a.h * a.wd;
        for (int e = lane; e < 2 * steps * BHP; e += 32) {
          const int c8 = e / BHP, q = e % BHP, c = c8 * 8;  // ch % 8 == 0: 8 channels lie wholly in x or in feat
          const int gy = ty0 - 1 + q / BH, gx = tx0 - 1 + q % BH;
          const bool ok = gy >= 0 && gy < a.h && gx >= 0 && gx < a.wd && c < a.cin;
          const bf16* src = a.x;
          if (ok) {
            const size_t pix = base + (size_t)gy * a.wd + gx;
            src = c < a.ch ? a.x + pix * a.ch + c : a.feat + pix * a.fc + (c - a.ch);
          }
          cp_async16(smem_u32(dst + (c8 * BHP + q) * 16), src, ok);
        }
        cp_async_mbar_arrive(full);
      }
    }
    PROBE(if (lane == 0) atomicAdd(&probe_sums[4], (unsigned long long)waited));
    return;
  }

  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, tig = lane & 3;
  float bias[FN / 8][2];
#pragma unroll
  for (int j = 0; j < FN / 8; ++j) {
    const int co = co0 + 8 * j + 2 * tig;  // cout % 8 == 0: an 8-channel group is wholly in or out
    bias[j][0] = co < a.cout ? a.bias[co] : 0.f;
    bias[j][1] = co < a.cout ? a.bias[co + 1] : 0.f;
  }
  const uint32_t wb = smem_u32(s_w);
  float acc[FN / 2];
#pragma unroll
  for (int q = 0; q < FN / 2; ++q) acc[q] = 0.f;
  PROBE(long long pw = 0, pp = 0, pe = 0; int pt = 0);
  // At most one consumer a slot (ring >= consumers), tiles in turn. A
  // consumer waits for its slot's last use to be released before it waits
  // for the slot to be filled: a later tile's copy may land before an
  // earlier one's, and without that wait the fill barrier could be two
  // phases behind, when its parity reads as the phase asked for. With it
  // (the producer fills in order, and this consumer's previous tile was
  // filled) both barriers are at most one phase from the one waited on.
  const int consumers = CONSUMERS < a.ring ? CONSUMERS : a.ring;
  if (wg >= consumers) return;
  for (int i = wg; i < count; i += consumers) {
    const int slot = i % a.ring, use = i / a.ring;
    PROBE(const long long c0 = clock64());
    if (use > 0) mbar_wait(empty0 + 8 * slot, (use - 1) & 1);
    mbar_wait(full0 + 8 * slot, use & 1);
    if constexpr (!TMA) fence_async_smem();  // the producer's cp.async copies, for wgmma
    PROBE(const long long c1 = clock64());
    // this thread's pixels: tile rows 2 wq (+ 1), column g
    const int t = first + i * stride, img = t / per;
    const int ty0 = (t % per) / a.tiles_x * BT, tx0 = (t % per) % a.tiles_x * BT;
    bool in[2];
    size_t pix[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int gy = ty0 + 2 * wq + hr, gx = tx0 + g;
      in[hr] = gy < a.h && gx < a.wd;
      pix[hr] = (size_t)img * a.h * a.wd + (in[hr] ? (size_t)gy * a.wd + gx : 0);
    }
    const uint32_t hb = smem_u32(s_h + slot * L.halo);
    fence_regs<FN / 2>(acc);
    wgmma_fence();
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        // output pixel (r, c) reads halo pixel (r + tap / 3, c + tap % 3)
        const int shift = (tap / 3) * BH + tap % 3;
        // TMA: 16-channel step s is 32 bytes into box s / 4's rows (ch % 64 == 0)
        const uint64_t da = TMA ? smem_desc(hb + (s >> 2) * BOX_SLOT + shift * 128 + (s & 3) * 32, 16, BH * 128, SW128)
                                : smem_desc(hb + (2 * s * BHP + shift) * 16, BHP * 16, BH * 16);
        const uint64_t db = smem_desc(wb + (s * 9 + tap) * W_TAP, W_TAP / 2, 128);
        wgmma_n32(acc, da, db, s > 0 || tap > 0);
      }
    }
    wgmma_commit();
    // conv 4 reads x for the residual while its products run (two bf16 a
    // 32-bit load; the stores below would otherwise wait on each load in turn)
    uint32_t xr[2][FN / 8];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int j = 0; j < FN / 8; ++j) {
        const int co = co0 + 8 * j + 2 * tig;
        xr[hr][j] = LAST && in[hr] && co < a.cout ? *reinterpret_cast<const uint32_t*>(a.x + pix[hr] * a.ch + co) : 0u;
      }
    wgmma_wait0();
    fence_regs<FN / 2>(acc);
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);  // this warp is done with the slot
    PROBE(const long long c2 = clock64());

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (!in[hr]) continue;
#pragma unroll
      for (int j = 0; j < FN / 8; ++j) {
        const int co = co0 + 8 * j + 2 * tig;
        if (co >= a.cout) continue;
        float v0 = __fadd_rn(acc[4 * j + 2 * hr], bias[j][0]);
        float v1 = __fadd_rn(acc[4 * j + 2 * hr + 1], bias[j][1]);
        if constexpr (LAST) {
          // explicit roundings: no fused multiply-add, as in the reference
          const float2 x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[hr][j]));
          v0 = __fadd_rn(__fmul_rn(v0, 0.2f), x2.x);
          v1 = __fadd_rn(__fmul_rn(v1, 0.2f), x2.y);
          *reinterpret_cast<__nv_bfloat162*>(a.out + pix[hr] * a.ch + co) = __floats2bfloat162_rn(v0, v1);
        } else {
          v0 = v0 >= 0.f ? v0 : __fmul_rn(0.2f, v0);
          v1 = v1 >= 0.f ? v1 : __fmul_rn(0.2f, v1);
          *reinterpret_cast<__nv_bfloat162*>(a.out + pix[hr] * a.fc + a.out_off + co) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    PROBE(const long long c3 = clock64(); pw += c1 - c0; pp += c2 - c1; pe += c3 - c2; ++pt);
  }
  PROBE(if ((tid & 127) == 0) {
    atomicAdd(&probe_sums[0], (unsigned long long)pw);
    atomicAdd(&probe_sums[1], (unsigned long long)pp);
    atomicAdd(&probe_sums[2], (unsigned long long)pe);
    atomicAdd(&probe_sums[3], (unsigned long long)pt);
  });
}

// A tensor map of `base`, bf16 (n, h, wd, c) channels-last, boxes of 64
// channels x 10 x 10 pixels x 1 image, 128-byte swizzled, zeros out of
// bounds; cuTensorMapEncodeTiled taken once from the runtime. 0, or a
// cudaError_t / CUresult code.
int encode_halo(CUtensorMap* map, const void* base, int c, int wd, int h, int n) {
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
  const cuuint32_t box[4] = {BOX_C, BH, BH, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, elem,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <bool LAST, bool TMA>
cudaError_t launch_wgmma(const ConvArgs& a, const CUtensorMap& map_x, const CUtensorMap& map_f, int blocks,
                         int smem, cudaStream_t stream) {
  // above 48 KB only as opted-in dynamic shared memory; once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(conv3x3_wgmma_kernel<LAST, TMA>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(W_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, conv3x3_wgmma_kernel<LAST, TMA>, a, map_x, map_f);
}

// bf16: five wgmma launches. plan: [tma, blocks of conv 0 .. 4, ring slots
// of conv 0 .. 4], as ops/cuda/rdb.py's `_fwd_plan` makes it.
int rdb_forward_bf16(const bf16* x, bf16* feat, const bf16* w, const float* bias, bf16* out, int n, int h, int wd,
                     int ch, int gc, const int* plan, cudaStream_t stream) {
  const int fc = 4 * gc;
  const bool tma = plan[0] != 0;
  if (tma && (ch % BOX_C || gc % 16)) return -1;
  CUtensorMap map_x = {}, map_f = {};
  if (tma) {
    const int e1 = encode_halo(&map_x, x, ch, wd, h, n), e2 = encode_halo(&map_f, feat, fc, wd, h, n);
    if (e1 || e2) return e1 ? e1 : e2;
  }
  const int tiles_x = (wd + BT - 1) / BT, tiles_y = (h + BT - 1) / BT;
  size_t woff = 0;
  int boff = 0;
  for (int k = 0; k < 5; ++k) {
    const int cin = ch + k * gc, cout = k < 4 ? gc : ch;
    const int co_tiles = (cout + FN - 1) / FN, blocks = plan[1 + k], ring = plan[6 + k];
    const FwdSmem L(ch, cin, ring, tma);
    if (ring < 2 || L.total > SMEM_MAX || blocks < co_tiles || blocks % co_tiles) return -1;
    const ConvArgs a{x, feat, w + woff, bias + boff, k < 4 ? feat : out, n, h, wd, ch, fc, cin, cout,
                     k * gc, co_tiles, tiles_y, tiles_x, ring};
    cudaError_t err;
    if (k < 4)
      err = tma ? launch_wgmma<false, true>(a, map_x, map_f, blocks, L.total, stream)
                : launch_wgmma<false, false>(a, map_x, map_f, blocks, L.total, stream);
    else
      err = tma ? launch_wgmma<true, true>(a, map_x, map_f, blocks, L.total, stream)
                : launch_wgmma<true, false>(a, map_x, map_f, blocks, L.total, stream);
    if (err != cudaSuccess) return (int)err;
    woff += (size_t)((cin + 15) / 16) * 9 * ((cout + 15) & ~15) * 16;
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

// One 3x3 'same' conv of the virtual concat [x (ch) | feat (fc)] over its
// first `cin` channels, output channels [co0, co0 + COUT) of image n, each
// warp 4 output rows x 8 columns. w: packed [cin/8][2][9][cout_pad][8] f32
// (hi, then lo; cout_pad = cout rounded up to 16, zero-padded).
// LAST = false: out = feat, writes lrelu(conv + b) at channel offset out_off.
// LAST = true:  out (N, H, W, ch) = (conv + b) * 0.2 + x.
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

  // ldmatrix lane roles, a 16-byte unit holding 4 f32 channels. A (16
  // pixels x 8 channels): matrices 0-3 are (first
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

  // epilogue: acc + bias in f32 into a [pixel][COUT + 8] tile (the padding
  // keeps a half-warp's float2 stores on distinct banks), then 8 channels a
  // store
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
// (w packed [ceil(cin/16)][9][cout rounded up to 16][16], zero-padded; `plan`
// the launches' [tma, blocks of conv 0 .. 4, ring slots of conv 0 .. 4],
// unread in f32); both on the tensor cores. Returns 0, the error code of the
// first failed launch, or -1 for arguments the kernel does not take.
// Launches on `stream`; does not synchronise.
extern "C" int rdb_forward_cuda(const void* x, void* feat, const void* w, const float* bias,
                                void* out, int n, int h, int wd, int ch, int gc, int dtype,
                                const int* plan, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || ch <= 0 || gc <= 0 || ch % 8 || gc % 8) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    // the f32 kernel tiles H by 16 rows and cout by 16 or 32
    const int widest = ch > gc ? ch : gc;
    if ((h + T_TH - 1) / T_TH > 65535 || (long long)n * ((widest + 15) / 16) > 65535) return -1;
    return rdb_forward_f32(static_cast<const float*>(x), static_cast<float*>(feat),
                           static_cast<const float*>(w), bias, static_cast<float*>(out), n, h, wd,
                           ch, gc, s);
  }
  if (dtype == 1) {
    if (plan == nullptr || (long long)n * ((h + BT - 1) / BT) * ((wd + BT - 1) / BT) > 0x7fffffffLL) return -1;
    return rdb_forward_bf16(static_cast<const bf16*>(x), static_cast<bf16*>(feat),
                            static_cast<const bf16*>(w), bias, static_cast<bf16*>(out), n, h, wd,
                            ch, gc, plan, s);
  }
  return -1;
}

extern "C" const char* rdb_error_string(int code) {
  return code < 0 ? "argument not supported by the kernel"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef SRGANFD_PROBE
// The bf16 kernel's phase counters (see probe_sums) into sums[0..7], then
// zeroed. 0 or a cudaError_t code.
extern "C" int rdb_probe_read(unsigned long long* sums) {
  cudaError_t err = cudaMemcpyFromSymbol(sums, probe_sums, sizeof(probe_sums));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(probe_sums, zero, sizeof(zero));
}
#endif
