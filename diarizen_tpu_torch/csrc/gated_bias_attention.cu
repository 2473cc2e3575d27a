// Attention with a fused, query-gated relative-position bias: the forward
// (K1) and its backward (K2).
//
//   s[b,h,i,j] = q[b,h,i,:] . k[b,h,j,:] / sqrt(D) + gate[b,h,i] * bias[h,i,j]
//   w = softmax_j(s),  o[b,h,i,:] = sum_j (w * m)[b,h,i,j] v[b,h,j,:]
//
// where m is the attention-dropout keep mask in {0, 1/(1-rate)} (all ones at
// rate 0), a pure hash of (seed, b, h, i, j) that the backward replays.
//
// K1 replaces the Pallas TPU kernel diarizen_tpu/ops/flash_attention.py:_kernel
// (l.201, pallas_call l.302; launched by flash_attention_gated_bias) with its
// three static softmax schedules (softmax_mode, Schedule below); p is the
// exp of the scores less the row max, l its f32 row sum, taken before the
// dropout mask as in the TPU kernel:
//  * f32: w = p / l, times the mask, rounded to the input type for w @ v.
//    The normaliser must be known before w is rounded, so the kernel walks
//    the key tiles twice in one launch: the first pass computes q k^T and
//    the gated bias for the row max and sum only (no V is loaded), the
//    second recomputes them and accumulates the rounded w @ v in f32, with
//    no division at the end.
//  * deferred: unnormalised p @ v accumulated in f32 and one divide by l at
//    the end, in one pass with a running max (the online softmax): a tile's
//    p is rounded to the input type relative to the max so far and the
//    accumulator rescaled when the max grows, where the TPU kernel rounds p
//    relative to the row's max. The serving default.
//  * bf16: deferred with p = exp of the shifted scores rounded to bf16, a
//    bf16 value (and the keep scale and p * keep in bf16), in two passes as
//    f32, so that p is rounded relative to the row max as the TPU kernel
//    does; the first pass takes the max only.
// Each schedule has an instance without the dropout mask (rate 0: no hash,
// no keep bits, as the TPU kernel compiles no mask at rate 0), and the f32
// schedule one with it: no path runs inference with dropout in another.
// The training forward runs the f32 schedule and also writes the f32 row
// log-sum-exp lse = max + log(l) that K2 needs; inference leaves lse alone.
//
// K2 replaces the Pallas TPU kernel ops/flash_attention.py:_bwd_kernel
// (launched by _flash_bwd). With W = exp(s - lse), dW' = dO V^T,
// D = rowsum(W * dW' * m) (the TPU kernel's r; in f32 pass A takes the
// equal rowsum(dO * O)) and dS = W * (dW' * m - D), it writes
//   dq = dS K / sqrt(D),  dk = dS^T Q / sqrt(D),  dv = (W * m)^T dO,
//   dgate[b,h,i] = sum_j dS * bias[h,i,j],  dbias[h,i,j] = sum_b gate * dS.
// The TPU kernel carries dbias from one grid step to the next along its
// sequential batch axis; on Hopper blocks run in no order, so K2 is three
// launches that need no atomics:
//  * pass A (dq, dgate, a partial dbias, D): one block per (head, 64 query
//    rows, batch chunk). The wrapper splits the batch into S chunks of
//    consecutive elements. S comes from the batch, heads, T, the number of
//    SMs and the blocks an SM holds at once: the grid fills at least two
//    waves of the SMs, and among such S the plan takes the one whose rounds
//    of resident blocks times the batch elements of the largest chunk is
//    least (fewest chunks among equals). At B 16, H 12, T 399 on 132 SMs
//    with two resident blocks each, that is S = 6 and 504 blocks, against 84
//    blocks without the split; S = 4 (336 blocks for 264 slots) leaves the
//    card three quarters idle for a second round of four-element blocks. A
//    block loops over its chunk's batch elements in order and, for each,
//    twice over the 64-key tiles (in bf16: first for D, then for dS); it
//    owns its rows of its chunk's f32 dbias slice (S, H, T, ldb) in
//    scratch for the whole call and adds each batch element's tile in place
//    (the rows stay in L2). In bf16 it does so as float2 pairs, since a lane
//    of the m16n8k16 accumulator owns two neighbouring columns, with all of
//    a tile's earlier pairs requested at once; the K, V and 64 x 64 bias
//    tiles of the next step are copied by cp.async into a second buffer
//    while a step computes (the wrapper pads the bias rows to a multiple of
//    8 so that they load in 16 bytes). dq, dgate and D are per (batch, head,
//    row) and written by the chunk that owns the batch element.
//  * the sum: dbias = the S slices added in chunk order, one thread per
//    element: a fixed order, so dbias is the same bit for bit from call to
//    call.
//  * pass B (dk, dv): one block per (batch, head, 64 keys) loops over the
//    query tiles, FlashAttention-2 style, with the saved lse and D.
// Keys past T get dS = 0 and W = 0; query rows past T contribute nothing.
//
// Bound on an H100 at WavLM-Base training shapes (B 16, H 12, T 399, D 64,
// bf16): K1 moves about 44 MB (q, k, v, o, bias, gate, lse) against 7.8
// GFLOP, K2 about 91 MB (q, k, v, o, dO read, dq, dk, dv written, the bias
// read, dbias written in f32) against 19.6 GFLOP of the five products it
// needs; at 3.35 TB/s and 989 TFLOP/s both are bound by bytes (K1: 13.0
// us). K1's inference instance at the unpruned `base` model's shape (B 32,
// H 12) moves 82.9 MB against 15.6 GFLOP: 24.7 us by bytes. The dropout
// instances also have an issue-rate floor: about 30 instructions per score
// (19 of them the dropout hash) over 30.6 M scores at 132 SMs x 4
// schedulers x 32 lanes x 1.98 GHz is about 27 us, above their byte bound.
// The split adds the S partial slices (4 x 7.6 MB written and read at that
// shape), which stay in the 50 MB L2.
//
// K1, bfloat16 (every instance; sm_90a):
//  * A block owns 128 query rows of one (batch, head): two warpgroups of 64
//    rows, 256 threads, two blocks an SM at D 64 (128 registers, 82 KB of
//    shared memory each). Grid: ceil(T / 128) x B H. At T 399 that is 128
//    blocks at (B 32, H 1), the smallest head count a served model launches
//    (one block on each of 128 SMs, one partial wave); 1536 at (32, 12),
//    the `base` model (5.8 rounds of the 264 resident blocks); 768 at the
//    training shape (16, 12), 2.9 rounds. A warpgroup whose rows all lie
//    past T (the last tile's second at T 399) leaves at once.
//  * Q (staged once), the K and V tiles of 64 keys and the 128 x 64 bias
//    tile arrive by TMA into a two-stage ring behind full / empty mbarriers,
//    in the 128B-swizzled layout; tensor maps are 3-D per (b h) and per
//    head, so a box never crosses into the next head and rows past T read as
//    zeros. Thread 0 issues every load, a slot's refill as soon as the 8
//    warps have released it. There is no producer warp: it would cost a
//    warpgroup's worth of registers and the second block an SM (letting
//    the last warp to release a slot refill it measured no faster). The
//    bias is read with a row stride ldbias (a multiple of 8, 16-byte rows),
//    so its tile is staged like the others and each lane reads bf16 pairs
//    from shared memory, without bank conflicts through the swizzle.
//  * Both products on wgmma m64n64k16 (f32 accumulate): s = q k^T with Q
//    and K from shared memory (K-major); o += p v with p from registers (the
//    accumulator rounded to bf16 in place, which is the A layout) and the V
//    tile MN-major. The f32 and deferred schedules run in base 2
//    (ex2.approx of scores scaled by log2(e)); bf16 keeps the scores in
//    natural units, rounds the shifted score to bf16 and takes ex2 of it
//    times log2(e) in f32, whose rounding (2^-24 relative) lies far below
//    bf16's (2^-9), so p differs from exp in bf16 only where ex2.approx's
//    two ulps cross a bf16 rounding boundary. Both passes of a two-pass
//    schedule stream their tiles through the same ring.
//  * The dropout instances compute the 32 keep bits of a lane's scores
//    while that tile's q k^T runs on the tensor cores, so the hash is off
//    the critical path; the bits select p * keep_scale or 0 after the sum.
//
// K2 and the float32 instance of K1: 64-row tiles staged in shared memory,
// rows past T zero-filled when a tile is staged, keys past T masked in the
// kernel.
//  * bfloat16 (K2): four warps, 16 rows each; every product on the tensor
//    cores with mma.sync m16n8k16 (f32 accumulate). An accumulator's
//    register layout is the A-operand layout of the next product, so dS and
//    W * m are rounded to bf16 in registers and never touch shared memory.
//  * float32: 256 threads on the CUDA cores in f32, exact for f32 inputs;
//    K1 there has the three schedules too (f32 and deferred differ only by
//    reassociation for f32 inputs; bf16 still rounds the scores), with a
//    first pass over the K tiles in the f32 and bf16 schedules.
// K2's passes have an instance without the mask replay for rate 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

namespace {

// the TPU kernel's softmax_mode, numbered as ops/flash_attention.py's SOFTMAX_MODES
enum Schedule : int { kF32 = 0, kDeferred = 1, kBf16 = 2 };

constexpr int kBlockQ = 64;        // query rows per block
constexpr int kBlockK = 64;        // keys per shared-memory tile
constexpr float kMasked = -1e30f;  // score of a key past T

// ---------------------------------------------------------------------------
// attention dropout: the TPU kernel's hash (ops/flash_attention.py
// _dropout_mask), bit for bit, in uint32 arithmetic

struct Dropout {
  uint32_t seed;
  uint32_t threshold;  // int(rate * (2^32 - 1)): keep where hash >= threshold
  float keep_scale;    // float32(1) / float32(1 - rate)
};

// the two per-(batch, head) streams: murmur3's finaliser on the seed
__device__ __forceinline__ void dropout_streams(uint32_t seed, int b, int h,
                                                uint32_t& s1, uint32_t& s2) {
  uint32_t s0 = seed + (uint32_t)b * 0x9E3779B1u + (uint32_t)h * 0x85EBCA77u;
  s0 ^= s0 >> 16;
  s0 *= 0x85EBCA6Bu;
  s0 ^= s0 >> 13;
  s0 *= 0xC2B2AE35u;
  s1 = s0 ^ (s0 >> 16);
  s2 = s1 * 0x9E3779B1u;
}

// the hash of (row, col): xorshift rounds on the absolute position
__device__ __forceinline__ uint32_t dropout_hash(uint32_t s1, uint32_t s2, uint32_t r,
                                                 uint32_t c) {
  uint32_t x = ((r + s1) << 16) ^ (c + s2);
  x ^= x << 13;
  x ^= x >> 17;
  x ^= x << 5;
  x = x + (r ^ (c << 11)) + s1;
  x ^= x << 13;
  x ^= x >> 17;
  x ^= x << 5;
  return x;
}

// keep value of (row, col); 1 in an instance without dropout
template <bool kDrop>
__device__ __forceinline__ float dropout_keep(uint32_t s1, uint32_t s2, uint32_t r,
                                              uint32_t c, const Dropout& dr) {
  if (!kDrop) return 1.f;
  return dropout_hash(s1, s2, r, c) >= dr.threshold ? dr.keep_scale : 0.f;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores

constexpr int kWarps = 4;  // each warp owns 16 rows

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8 and receives, per matrix, rows 2 (l % 4) and 2 (l % 4) + 1
// of column l / 4 -- the B operand of m16n8k16 from a row-major (k, n) tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [r0, r0 + 64) of a (t, d) bf16 matrix into shared memory as
// (64, kDim + 8) with zeros past t and d; d % 8 == 0 and 16-byte aligned rows.
template <int kDim>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int r0, int t, int d) {
  constexpr int kChunks = kDim / 8;  // 16-byte chunks per row
  constexpr int ld = kDim + 8;
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kWarps * 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < t && c < d) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: nothing is read, 16 zero bytes are written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// load_tile through cp.async: the copies are issued, not waited for
template <int kDim>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int r0, int t, int d) {
  constexpr int kChunks = kDim / 8;
  constexpr int ld = kDim + 8;
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kWarps * 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool valid = r0 + r < t && c < d;
    cp_async_16(dst + r * ld + c, valid ? src + (size_t)(r0 + r) * d + c : src, valid);
  }
}

// A-operand fragments of the warp's 16 rows of a staged (64, kDim + 8) tile
template <int kDim>
__device__ __forceinline__ void load_a_fragments(uint32_t (&f)[kDim / 16][4],
                                                 const __nv_bfloat16* tile, int r, int c2) {
  constexpr int ld = kDim + 8;
#pragma unroll
  for (int s = 0; s < kDim / 16; ++s) {
    const __nv_bfloat16* base = tile + r * ld + 16 * s + c2;
    f[s][0] = load_u32(base);
    f[s][1] = load_u32(base + 8 * ld);
    f[s][2] = load_u32(base + 8);
    f[s][3] = load_u32(base + 8 * ld + 8);
  }
}

// acc[j] = A (16 rows, kDim) . B^T for the 8 column tiles of 8 rows of a
// staged (64, kDim + 8) tile B: a 16 x 64 product over the head dim
template <int kDim>
__device__ __forceinline__ void mma_rows_by_tile(float (&acc)[8][4],
                                                 const uint32_t (&a)[kDim / 16][4],
                                                 const __nv_bfloat16* tile, int g, int c2) {
  constexpr int ld = kDim + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const __nv_bfloat16* base = tile + (8 * j + g) * ld + c2;
#pragma unroll
    for (int st = 0; st < kDim / 16; ++st)
      mma_bf16(acc[j], a[st], load_u32(base + 16 * st), load_u32(base + 16 * st + 8));
  }
}

// out[j] += P (16 rows, 64) . tile (64, kDim): P from a 16 x 64 accumulator
// rounded to bf16, the tile's rows through ldmatrix.trans
template <int kDim>
__device__ __forceinline__ void mma_acc_by_tile(float (&out)[kDim / 8][4], const float (&p)[8][4],
                                                const __nv_bfloat16* tile, int lane) {
  constexpr int ld = kDim + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // 16 rows of the tile per step
    uint32_t pa[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * kk + half;
      pa[2 * half] = pack_bf16(p[j][0], p[j][1]);
      pa[2 * half + 1] = pack_bf16(p[j][2], p[j][3]);
    }
    const int row = 16 * kk + (lane / 8 % 2) * 8 + lane % 8;
#pragma unroll
    for (int j = 0; j < kDim / 8; j += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + row * ld + 8 * (j + lane / 16));
      mma_bf16(out[j], pa, b[0], b[1]);
      mma_bf16(out[j + 1], pa, b[2], b[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// K1, bfloat16: TMA ring, wgmma (both products), one producer warp

constexpr int kFwdWarpgroups = 2;                 // of 64 query rows each
constexpr int kFwdRows = 64 * kFwdWarpgroups;     // query rows per block
constexpr int kFwdStages = 2;                     // K, V and bias ring
constexpr int kFwdThreads = 128 * kFwdWarpgroups;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// Wait for the phase of parity `parity` to complete, in one PTX loop (no
// branch of the compiler's own in the code around the wgmma); threads where
// `pred` is false pass at once. A phase that never completes (a TMA
// transaction lost) traps after 2^24 tries instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity, bool pred = true) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\n"
      "setp.eq.u32 p, %2, 0;\n"
      "@p bra MBAR_DONE;\n"
      "mov.u32 n, 0;\n"
      "MBAR_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra MBAR_DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 16777216;\n"
      "@p bra MBAR_WAIT;\n"
      "trap;\n"
      "MBAR_DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity), "r"((uint32_t)pred)
      : "memory");
}

// The mbarrier operations below act only where `pred` holds, through a PTX
// predicate.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(smem_u32(bar)),
      "r"(bytes), "r"((uint32_t)pred)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"((uint32_t)pred)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %6, 0;\n"
      "@p cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n}\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"((uint32_t)pred)
      : "memory");
}

// wgmma descriptor of a K-major tile in the 128B-swizzled layout TMA writes:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), base 1024-aligned.
// One k16 step further along K is 32 bytes: +2 in the address field.
__device__ __forceinline__ uint64_t sw128_desc(const void* smem) {
  return (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The same for an MN-major operand (the V tile: a 128-byte row per key, 64
// columns of N): a k16 step is two 8-key atoms 1024 bytes apart. N is one
// 64-column atom, so only that stride is read; LBO and SBO both hold it.
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* smem) {
  return (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the instruction that issues or waits for it.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64 f32 of the warpgroup) (+)= A (64 x 16, shared memory) . B (16 x
// 64, shared memory, K-major). Thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 (d[4 j], d[4 j + 1]) and that + 8 (d[4 j + 2],
// d[4 j + 3]), columns 8 j + 2 (t % 4) and + 1.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d = A . B as wgmma_ss with d not read: the first k16 step of a product.
// The accumulator's old values are no operand, so the compiler keeps no
// instruction that made them inside the wgmma pipeline.
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0u));
}

// d += A (64 x 16 bf16 in registers: the m16n8k16 A layout per warp) . B
// (16 x 64, shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1u));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of the forward block, in bytes from a 1024-aligned base:
// Q (kDim / 64 column halves of kFwdRows x 128 bytes), then per ring stage
// K and V (kDim / 64 halves of 64 keys x 128 bytes each) and the bias tile
// (kFwdRows x 64 keys), then the barriers. TMA writes every tile in the
// 128B-swizzled layout.
template <int kDim>
struct FwdLayout {
  static constexpr int kHalves = kDim / 64;
  static constexpr uint32_t kQBytes = kFwdRows * kDim * 2;
  static constexpr uint32_t kKVBytes = kBlockK * kDim * 2;
  static constexpr uint32_t kBiasBytes = kFwdRows * kBlockK * 2;
  static constexpr uint32_t kStageBytes = 2 * kKVBytes + kBiasBytes;
  static constexpr uint32_t kBarriers = kQBytes + kFwdStages * kStageBytes;
  static constexpr size_t kSmem = kBarriers + (2 * kFwdStages + 1) * sizeof(uint64_t) + 1024;
};

// s = q k^T of one key tile over the head dim, issued and committed, not
// waited for
template <int kDim>
__device__ __forceinline__ void issue_scores(float (&s)[32], const uint64_t (&qd)[kDim / 64],
                                             const unsigned char* k_tile) {
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < kDim / 16; ++st) {
    const uint64_t kd = sw128_desc(k_tile + (st / 4) * kBlockK * 128);
    if (st == 0)
      wgmma_ss_first(s, qd[0], kd);
    else
      wgmma_ss(s, qd[st / 4] + 2 * (st % 4), kd + 2 * (st % 4), 1u);
  }
  wgmma_commit();
}

// The dropout keep bits of this lane's 32 scores of a key tile (bit
// 4 j + 2 i + e: accumulator entry 4 j + 2 i + e, row i, column
// k0 + 8 j + 2 c + e).
__device__ __forceinline__ uint32_t keep_bits(uint32_t s1, uint32_t s2, const int (&row)[2],
                                              int k0, int c, uint32_t threshold) {
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t x = dropout_hash(s1, s2, row[i], k0 + 8 * j + 2 * c + e);
        bits |= (x >= threshold ? 1u : 0u) << (4 * j + 2 * i + e);
      }
  return bits;
}

// The scores of one key tile in place, in the units of c1 and gt2 (base 2
// or natural): x = s c1 + gt2 bias from the staged tile, keys past t set to
// kMasked when kTail, and with kMax the tile's row maxima, reduced over the
// 4 lanes of a row group (which hold its 64 columns).
template <bool kTail, bool kMax>
__device__ __forceinline__ void tile_scores(float (&s)[32], float (&tmax)[2],
                                            const __nv_bfloat16* bias_row, int g, int c,
                                            float c1, const float (&gt2)[2], int k0, int t) {
  tmax[0] = tmax[1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // row r of the tile holds 16-byte chunk j at chunk j ^ (r % 8); r % 8 == g
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          bias_row + i * 8 * kBlockK + ((j ^ g) * 8) + 2 * c));
      float x0 = fmaf(s[4 * j + 2 * i], c1, gt2[i] * b.x);
      float x1 = fmaf(s[4 * j + 2 * i + 1], c1, gt2[i] * b.y);
      if (kTail) {
        const int col = k0 + 8 * j + 2 * c;
        if (col >= t) x0 = kMasked;
        if (col + 1 >= t) x1 = kMasked;
      }
      s[4 * j + 2 * i] = x0;
      s[4 * j + 2 * i + 1] = x1;
      if (kMax) tmax[i] = fmaxf(tmax[i], fmaxf(x0, x1));
    }
  }
  if (kMax) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
    }
  }
}

// The first pass of a two-pass schedule over one tile of scores x: the
// running row max m and, in the f32 schedule, this lane's share of the row
// sum of 2^(x - m), rescaled when m grows.
template <int kMode>
__device__ __forceinline__ void tile_stats(const float (&s)[32], const float (&tmax)[2],
                                           float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], tmax[i]);  // finite: key 0 is valid
    if (kMode == kF32) l[i] *= ex2(m[i] - m_new);
    m[i] = m_new;
  }
  if (kMode == kF32) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        l[i] += ex2(s[4 * j + 2 * i] - m[i]) + ex2(s[4 * j + 2 * i + 1] - m[i]);
  }
}

// The weights of one tile of scores x, rounded to bf16 in the A layout of
// the p @ v product:
//  * deferred: p = 2^(x - m) with m the running max, l += p;
//  * f32: w = 2^(x - m) / l with m and l of the whole row (first pass);
//  * bf16: p = bf16(e^bf16(x - m)) with x and m in natural units and m the
//    row max, l += p.
// The dropout instances then take bit 4 j + 2 i + e of `keep`: p * keep_scale
// or 0 (in bf16 for the bf16 schedule, whose keep_scale is bf16-rounded).
template <int kMode, bool kDrop>
__device__ __forceinline__ void tile_weights(float (&s)[32], uint32_t (&p)[16],
                                             const float (&m)[2], float (&l)[2],
                                             const float (&inv_l)[2], uint32_t keep,
                                             float keep_scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float w[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = s[4 * j + 2 * i + e];
        if (kMode == kBf16) {
          w[e] = round_bf16(ex2(round_bf16(x - m[i]) * kLog2e));
        } else {
          w[e] = ex2(x - m[i]);
        }
        if (kMode == kF32) {
          w[e] *= inv_l[i];
        } else {
          l[i] += w[e];
        }
        if (kDrop) {
          const float kept = kMode == kBf16 ? round_bf16(w[e] * keep_scale) : w[e] * keep_scale;
          w[e] = (keep >> (4 * j + 2 * i + e)) & 1u ? kept : 0.f;
        }
        s[4 * j + 2 * i + e] = w[e];
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // keys 16 kk .. 16 kk + 15: accumulator tiles 2 kk, 2 kk + 1
#pragma unroll
    for (int e = 0; e < 4; ++e) p[4 * kk + e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  }
}

// Block (query tile of kFwdRows rows, b * h + head): two warpgroups of 64
// query rows. Lane (g = lane / 4, c = lane % 4) of warp w of warpgroup wg
// owns rows q0 + 64 wg + 16 w + g and + 8, and in each 8-wide column tile the
// columns 2 c and 2 c + 1. lse: the row log-sum-exp, written when not null.
template <int kDim, int kMode, bool kDrop>
__global__ void __launch_bounds__(kFwdThreads, kDim == 64 ? 2 : 1)
gated_bias_attention_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 const __grid_constant__ CUtensorMap bias_map,
                                 const float* __restrict__ gate,
                                 __nv_bfloat16* __restrict__ out,
                                 float* __restrict__ lse,
                                 int num_heads, int t, int d, float scale, Dropout dr) {
  using L = FwdLayout<kDim>;
  constexpr bool kTwoPass = kMode != kDeferred;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(base + L::kBarriers);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + kFwdStages;
  auto stage = [&](int slot) { return base + L::kQBytes + slot * L::kStageBytes; };

  const int q0 = blockIdx.x * kFwdRows;
  const int bh = blockIdx.y, h = bh % num_heads;
  const int tiles = (t + kBlockK - 1) / kBlockK;
  // loads through the ring: a two-pass schedule's first pass reads the K
  // and bias tiles of every key tile, then the second K, V and bias again
  const int loads = kTwoPass ? 2 * tiles : tiles;
  const int active = min(kFwdWarpgroups, (t - q0 + 63) / 64);  // warpgroups with rows < t
  const int wg = threadIdx.x / 128;
  const bool producer = threadIdx.x == 0;

  // load n of the ring into its slot (thread 0)
  auto load_tile = [&](int n) {
    const int slot = n % kFwdStages, j = n < tiles ? n : n - tiles;
    const bool with_v = !kTwoPass || n >= tiles;
    unsigned char* st = stage(slot);
    mbar_expect_tx(&full[slot], with_v ? L::kStageBytes : L::kStageBytes - L::kKVBytes, producer);
#pragma unroll
    for (int hf = 0; hf < L::kHalves; ++hf) {
      tma_load_3d(st + hf * kBlockK * 128, &k_map, &full[slot], 64 * hf, j * kBlockK, bh,
                  producer);
      tma_load_3d(st + L::kKVBytes + hf * kBlockK * 128, &v_map, &full[slot], 64 * hf,
                  j * kBlockK, bh, producer && with_v);
    }
    tma_load_3d(st + 2 * L::kKVBytes, &bias_map, &full[slot], j * kBlockK, q0, h, producer);
  };

  if (producer) {
    mbar_init(q_bar, 1);
    for (int i = 0; i < kFwdStages; ++i) {
      mbar_init(&full[i], 1);            // thread 0's expect_tx; TMA completes the bytes
      mbar_init(&empty[i], 4 * active);  // one arrive per warp that reads the slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg >= active) return;  // no query row of this warpgroup is below t
  mbar_expect_tx(q_bar, L::kQBytes, producer);
#pragma unroll
  for (int hf = 0; hf < L::kHalves; ++hf)
    tma_load_3d(base + hf * kFwdRows * 128, &q_map, q_bar, 64 * hf, q0, bh, producer);
  for (int n = 0; n < kFwdStages && n < loads; ++n) load_tile(n);  // the ring starts empty

  const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int r_tile = 64 * wg + 16 * (threadIdx.x % 128 / 32) + g;  // first row within the block
  const int row[2] = {q0 + r_tile, q0 + r_tile + 8};
  // scores in base 2 (x = s log2(e)), in natural units for the bf16 schedule
  const float unit = kMode == kBf16 ? 1.f : kLog2e;
  const float c1 = scale * unit;
  const float keep_scale = kMode == kBf16 ? round_bf16(dr.keep_scale) : dr.keep_scale;
  float gt2[2], m[2], l[2], inv_l[2] = {1.f, 1.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    gt2[i] = row[i] < t ? gate[(size_t)bh * t + row[i]] * unit : 0.f;
    m[i] = -INFINITY;
    l[i] = 0.f;  // this lane's share of the row sum; lanes are summed at the end
  }
  uint32_t s1 = 0, s2 = 0;
  if (kDrop) dropout_streams(dr.seed, bh / num_heads, h, s1, s2);
  uint64_t qd[L::kHalves];
  float o[L::kHalves][32];
#pragma unroll
  for (int hf = 0; hf < L::kHalves; ++hf) {
    qd[hf] = sw128_desc(base + hf * kFwdRows * 128 + wg * 64 * 128);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hf][i] = 0.f;
  }
  float sc[32], tmax[2];
  uint32_t p[16];
  mbar_wait(q_bar, 0);

  // this warp no longer reads load n: its slot goes back to the ring, and
  // thread 0 refills it with load n + 2 once all warps have released it
  auto release = [&](int n) {
    const int slot = n % kFwdStages;
    __syncwarp();
    mbar_arrive(&empty[slot], lane == 0);
    if (n + kFwdStages < loads) {
      mbar_wait(&empty[slot], (n / kFwdStages) & 1, producer);
      load_tile(n + kFwdStages);
    }
  };

  if (kTwoPass) {  // first pass: q k^T and the bias of every key tile, for m (and l)
    for (int j = 0; j < tiles; ++j) {
      unsigned char* st = stage(j % kFwdStages);
      mbar_wait(&full[j % kFwdStages], (j / kFwdStages) & 1);
      issue_scores<kDim>(sc, qd, st);
      const int k0 = j * kBlockK;
      wgmma_wait<0>();
      fence_regs(sc);
      const __nv_bfloat16* bias_row =
          reinterpret_cast<const __nv_bfloat16*>(st + 2 * L::kKVBytes) + r_tile * kBlockK;
      if (k0 + kBlockK <= t)
        tile_scores<false, true>(sc, tmax, bias_row, g, c, c1, gt2, k0, t);
      else
        tile_scores<true, true>(sc, tmax, bias_row, g, c, c1, gt2, k0, t);
      tile_stats<kMode>(sc, tmax, m, l);
      release(j);
    }
    if (kMode == kF32) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // the row's sum, in every lane of its group
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        inv_l[i] = 1.f / l[i];
      }
    }
  }

  // Key tile j: q k^T is issued; while it runs on the tensor cores the
  // dropout instances hash the tile's keep bits. The softmax makes p, and
  // p @ v is issued and waited for; then the slot goes back to the ring. (A
  // p @ v left in flight into the next tile makes ptxas serialise every
  // wgmma; issuing the next tile's q k^T before this tile's softmax measured
  // slower.)
  const int first = kTwoPass ? tiles : 0;
  for (int j = 0; j < tiles; ++j) {
    const int n = first + j, slot = n % kFwdStages;
    unsigned char* st = stage(slot);
    mbar_wait(&full[slot], (n / kFwdStages) & 1);
    issue_scores<kDim>(sc, qd, st);
    const int k0 = j * kBlockK;
    const uint32_t keep = kDrop ? keep_bits(s1, s2, row, k0, c, dr.threshold) : 0u;
    wgmma_wait<0>();
    fence_regs(sc);
    const __nv_bfloat16* bias_row =
        reinterpret_cast<const __nv_bfloat16*>(st + 2 * L::kKVBytes) + r_tile * kBlockK;
    if (k0 + kBlockK <= t)
      tile_scores<false, !kTwoPass>(sc, tmax, bias_row, g, c, c1, gt2, k0, t);
    else
      tile_scores<true, !kTwoPass>(sc, tmax, bias_row, g, c, c1, gt2, k0, t);
    if (!kTwoPass) {  // the running max; o and l rescaled by the factor of the old against the new
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], tmax[i]);  // finite: key 0 is valid
        corr[i] = ex2(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int hf = 0; hf < L::kHalves; ++hf)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[hf][i] *= corr[(i / 2) % 2];
    }
    tile_weights<kMode, kDrop>(sc, p, m, l, inv_l, keep, keep_scale);
    // p and the rescaled o are complete before the fence: the compiler may
    // not sink their instructions into the wgmma pipeline
    fence_regs(p);
#pragma unroll
    for (int hf = 0; hf < L::kHalves; ++hf) fence_regs(o[hf]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys per step
#pragma unroll
      for (int hf = 0; hf < L::kHalves; ++hf)
        wgmma_rs(o[hf], p + 4 * kk,
                 sw128_mn_desc(st + L::kKVBytes + hf * kBlockK * 128) + 128 * kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(p);
#pragma unroll
    for (int hf = 0; hf < L::kHalves; ++hf) fence_regs(o[hf]);
    release(n);
  }

  float out_scale[2] = {1.f, 1.f};  // the f32 schedule's w is normalised already
  if (kMode != kF32) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      out_scale[i] = 1.f / l[i];
    }
  }
  const size_t head = (size_t)bh * t * d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= t) continue;
    if (lse != nullptr && c == 0)  // natural units
      lse[(size_t)bh * t + row[i]] = kMode == kBf16 ? m[i] + logf(l[i])
                                                    : (m[i] + log2f(l[i])) * kLn2;
#pragma unroll
    for (int hf = 0; hf < L::kHalves; ++hf)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * hf + 8 * j + 2 * c;
        if (col < d) {
          *reinterpret_cast<__nv_bfloat162*>(out + head + (size_t)row[i] * d + col) =
              __floats2bfloat162_rn(o[hf][4 * j + 2 * i] * out_scale[i],
                                    o[hf][4 * j + 2 * i + 1] * out_scale[i]);
        }
      }
  }
}

// K2 pass A, bf16: one block per (head, 64 query rows, batch chunk),
// looping over the chunk's batch elements and, for each, over the 64-key
// tiles twice. The first sweep takes D = rowsum(W * dW' * m) as the TPU
// kernel's r = sum(dw * w), from the exact f32 W (the FlashAttention-2
// identity D = rowsum(dO * O) would read the forward's O, whose weights
// were rounded to bf16 for the p @ v product: off by more than the
// reference allows in dgate, which cancels D against the row's sum). The
// second computes dS, dq, dgate and the partial dbias. Lane layout as in
// K1. The K, V and bias tiles of the next (batch element, sweep, key tile)
// step are copied into the other half of a double buffer with cp.async
// while this step computes; the bias comes padded to rows of ldbias (a
// multiple of 8) elements so that its tiles load in 16 bytes.
template <int kDim, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ bias, int ldbias,
                             const float* __restrict__ gate,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq,
                             float* __restrict__ dgate,
                             float* __restrict__ dbias_part, int ldb,
                             int batch, int num_heads, int t, int d, float scale, Dropout dr) {
  constexpr int ld = kDim + 8;
  constexpr int kSteps = kDim / 16;
  constexpr int kOut = kDim / 8;
  constexpr int ldp = kBlockK + 8;
  constexpr int kTileKV = kBlockK * ld;   // elements of a K or V tile
  constexpr int kTileP = kBlockQ * ldp;   // elements of a bias tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kBlockQ * ld;
  __nv_bfloat16* ks = dos + kBlockQ * ld;  // two K tiles, then two V tiles, then two bias tiles
  __nv_bfloat16* vs = ks + 2 * kTileKV;
  __nv_bfloat16* pbs = vs + 2 * kTileKV;

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int b0 = blockIdx.z * batch / gridDim.z, b1 = (blockIdx.z + 1) * batch / gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int rq = 16 * warp + g;
  const int row[2] = {q0 + rq, q0 + rq + 8};
  const __nv_bfloat16* bias_h = bias + (size_t)h * t * ldbias;
  float* part = dbias_part + ((size_t)blockIdx.z * num_heads + h) * t * ldb;
  const int tiles = (t + kBlockK - 1) / kBlockK;
  const int steps = (b1 - b0) * 2 * tiles;  // per batch element: the D sweep, then the dS sweep

  // the K, V and bias tiles of step `st` into buffer st % 2
  auto prefetch = [&](int st) {
    const int buf = st & 1, k0 = (st % tiles) * kBlockK;
    const size_t head = (size_t)((b0 + st / (2 * tiles)) * num_heads + h) * t * d;
    load_tile_async<kDim>(ks + buf * kTileKV, k + head, k0, t, d);
    load_tile_async<kDim>(vs + buf * kTileKV, v + head, k0, t, d);
    for (int i = tid; i < kBlockQ * (kBlockK / 8); i += kWarps * 32) {
      const int r = i / (kBlockK / 8), c = (i % (kBlockK / 8)) * 8;
      const bool valid = q0 + r < t && k0 + c < ldbias;
      cp_async_16(pbs + buf * kTileP + r * ldp + c,
                  valid ? bias_h + (size_t)(q0 + r) * ldbias + k0 + c : bias_h, valid);
    }
    cp_async_commit();
  };

  uint32_t qf[kSteps][4], df[kSteps][4];
  float gt[2], ls[2], dl[2], dg[2];
  float dqa[kOut][4];
  uint32_t s1 = 0, s2 = 0;
  prefetch(0);
  for (int st = 0; st < steps; ++st) {
    const int b = b0 + st / (2 * tiles), kt = st % tiles, k0 = kt * kBlockK, buf = st & 1;
    const bool d_sweep = st % (2 * tiles) < tiles;
    const int bh = b * num_heads + h;
    const size_t head = (size_t)bh * t * d;
    if (d_sweep && kt == 0) {  // a new batch element: its q and dO rows, gate and lse
      load_tile<kDim>(qs, q + head, q0, t, d);
      load_tile<kDim>(dos, dout + head, q0, t, d);
      __syncthreads();
      load_a_fragments<kDim>(qf, qs, rq, c2);
      load_a_fragments<kDim>(df, dos, rq, c2);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool valid = row[i] < t;
        gt[i] = valid ? gate[(size_t)bh * t + row[i]] : 0.f;
        ls[i] = valid ? lse[(size_t)bh * t + row[i]] : 0.f;
        dl[i] = 0.f;  // this lane's share of D
      }
      if (kDrop) dropout_streams(dr.seed, b, h, s1, s2);
    }
    if (!d_sweep && kt == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) dg[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kOut; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
    }
    if (st + 1 < steps) {
      prefetch(st + 1);
      cp_async_wait<1>();  // this step's tiles have landed; the next step's are in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt_s = ks + buf * kTileKV;
    const __nv_bfloat16* pb_s = pbs + buf * kTileP;

    float s[8][4], dp[8][4];
    mma_rows_by_tile<kDim>(s, qf, kt_s, g, c2);              // q k^T
    mma_rows_by_tile<kDim>(dp, df, vs + buf * kTileKV, g, c2);  // dO v^T
    if (d_sweep) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + 8 * j + c2;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 pb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(pb_s + (rq + 8 * i) * ldp + 8 * j + c2));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col + e < t && row[i] < t) {
              const float w = expf(s[j][2 * i + e] * scale + gt[i] * (e == 0 ? pb.x : pb.y) - ls[i]);
              dl[i] += w * dp[j][2 * i + e] * dropout_keep<kDrop>(s1, s2, row[i], col + e, dr);
            }
          }
        }
      }
      if (kt == tiles - 1) {  // D of the rows: the 4 lanes of a row group hold its columns
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dl[i] += __shfl_xor_sync(0xffffffffu, dl[i], 1);
          dl[i] += __shfl_xor_sync(0xffffffffu, dl[i], 2);
          if (c2 == 0 && row[i] < t) delta[(size_t)bh * t + row[i]] = dl[i];
        }
      }
      __syncthreads();  // this step's buffer is no longer read
      continue;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = k0 + 8 * j + c2;
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // row i: accumulator entries 2 i, 2 i + 1
        const float2 pb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(pb_s + (rq + 8 * i) * ldp + 8 * j + c2));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pbe = e == 0 ? pb.x : pb.y;
          float ds = 0.f;
          if (col + e < t && row[i] < t) {
            const float w = expf(s[j][2 * i + e] * scale + gt[i] * pbe - ls[i]);
            ds = w * (dp[j][2 * i + e] * dropout_keep<kDrop>(s1, s2, row[i], col + e, dr) - dl[i]);
            dg[i] += ds * pbe;
          }
          s[j][2 * i + e] = ds;
        }
      }
    }
    // the partial dbias: the pairs the chunk's earlier batch elements left
    // (this lane wrote them) are all requested before the dS k product, and
    // stored with this element's gate * dS added after it
    float2 prev[8][2];
    if (b != b0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = k0 + 8 * j + c2;
          prev[j][i] = row[i] < t && col < t
                           ? *reinterpret_cast<const float2*>(part + (size_t)row[i] * ldb + col)
                           : make_float2(0.f, 0.f);
        }
    }
    mma_acc_by_tile<kDim>(dqa, s, kt_s, lane);  // dS k
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = k0 + 8 * j + c2;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (row[i] < t && col < t) {  // col + 1 < ldb; past t its contribution is 0
          float2 c = make_float2(gt[i] * s[j][2 * i], gt[i] * s[j][2 * i + 1]);
          if (b != b0) c = make_float2(prev[j][i].x + c.x, prev[j][i].y + c.y);
          *reinterpret_cast<float2*>(part + (size_t)row[i] * ldb + col) = c;
        }
      }
    }

    if (kt == tiles - 1) {  // the batch element is done: dgate and dq
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dg[i] += __shfl_xor_sync(0xffffffffu, dg[i], 1);
        dg[i] += __shfl_xor_sync(0xffffffffu, dg[i], 2);
        if (row[i] >= t) continue;
        if (c2 == 0) dgate[(size_t)bh * t + row[i]] = dg[i];
#pragma unroll
        for (int j = 0; j < kOut; ++j) {
          const int col = 8 * j + c2;
          if (col < d) {
            *reinterpret_cast<__nv_bfloat162*>(dq + head + (size_t)row[i] * d + col) =
                __floats2bfloat162_rn(dqa[j][2 * i] * scale, dqa[j][2 * i + 1] * scale);
          }
        }
      }
    }
    __syncthreads();  // this step's buffer and q, dO tiles are no longer read
  }
}

// K2 pass B, bf16: one block per (batch, head, 64 keys). Lane (g, c) of warp
// w owns keys 16 w + g and 16 w + g + 8; the "columns" of its score tiles are
// query rows.
template <int kDim, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ bias, int ldbias,
                               const float* __restrict__ gate,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv,
                               int num_heads, int t, int d, float scale, Dropout dr) {
  constexpr int ld = kDim + 8;
  constexpr int kSteps = kDim / 16;
  constexpr int kOut = kDim / 8;
  constexpr int ldp = kBlockK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kBlockK * ld;
  __nv_bfloat16* qs = vs + kBlockK * ld;
  __nv_bfloat16* dos = qs + kBlockQ * ld;
  __nv_bfloat16* pt = dos + kBlockQ * ld;  // bias tile, (64 queries, ldp)
  float* lse_s = reinterpret_cast<float*>(pt + kBlockQ * ldp);
  float* delta_s = lse_s + kBlockQ;
  float* gate_s = delta_s + kBlockQ;

  const int bh = blockIdx.x;
  const int b = bh / num_heads, h = bh % num_heads;
  const int k0 = blockIdx.y * kBlockK;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int rk = 16 * warp + g;
  const int key[2] = {k0 + rk, k0 + rk + 8};
  const size_t head = (size_t)bh * t * d;
  const __nv_bfloat16* bias_h = bias + (size_t)h * t * ldbias;

  load_tile<kDim>(ks, k + head, k0, t, d);
  load_tile<kDim>(vs, v + head, k0, t, d);
  __syncthreads();
  uint32_t kf[kSteps][4], vf[kSteps][4];
  load_a_fragments<kDim>(kf, ks, rk, c2);
  load_a_fragments<kDim>(vf, vs, rk, c2);
  uint32_t s1 = 0, s2 = 0;
  if (kDrop) dropout_streams(dr.seed, b, h, s1, s2);
  float dka[kOut][4], dva[kOut][4];
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
  }

  for (int q0 = 0; q0 < t; q0 += kBlockQ) {
    __syncthreads();  // the previous query tile is no longer read
    load_tile<kDim>(qs, q + head, q0, t, d);
    load_tile<kDim>(dos, dout + head, q0, t, d);
    for (int i = tid; i < kBlockQ * kBlockK; i += kWarps * 32) {
      const int qi = i / kBlockK, kj = i % kBlockK;
      const bool valid = q0 + qi < t && k0 + kj < t;
      pt[qi * ldp + kj] = valid ? bias_h[(size_t)(q0 + qi) * ldbias + k0 + kj] : __float2bfloat16(0.f);
    }
    if (tid < kBlockQ) {
      const bool valid = q0 + tid < t;
      const size_t at = (size_t)bh * t + q0 + tid;
      lse_s[tid] = valid ? lse[at] : 0.f;
      delta_s[tid] = valid ? delta[at] : 0.f;
      gate_s[tid] = valid ? gate[at] : 0.f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];
    mma_rows_by_tile<kDim>(st, kf, qs, g, c2);    // k q^T
    mma_rows_by_tile<kDim>(dpt, vf, dos, g, c2);  // v dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const int qi = 8 * j + c2 + (e & 1);
        const int qrow = q0 + qi;
        float wd = 0.f, ds = 0.f;
        if (qrow < t && key[i] < t) {
          const float pb = __bfloat162float(pt[qi * ldp + rk + 8 * i]);
          const float w = expf(st[j][e] * scale + gate_s[qi] * pb - lse_s[qi]);
          const float keep = dropout_keep<kDrop>(s1, s2, qrow, key[i], dr);
          wd = w * keep;
          ds = w * (dpt[j][e] * keep - delta_s[qi]);
        }
        st[j][e] = wd;
        dpt[j][e] = ds;
      }
    }
    mma_acc_by_tile<kDim>(dva, st, dos, lane);  // (W m)^T dO
    mma_acc_by_tile<kDim>(dka, dpt, qs, lane);  // dS^T q
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= t) continue;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int col = 8 * j + c2;
      if (col < d) {
        const size_t at = head + (size_t)key[i] * d + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dka[j][2 * i] * scale, dka[j][2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dva[j][2 * i], dva[j][2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores

constexpr int kThreadsY = 16;  // thread grid: 16 x 16 = 256
constexpr int kThreadsX = 16;
constexpr int kThreads = kThreadsY * kThreadsX;
constexpr int kRows = kBlockQ / kThreadsY;  // query rows per thread
constexpr int kKeys = kBlockK / kThreadsX;  // keys per thread per tile

// 64 rows [r0, r0 + 64) of a (t, d) f32 matrix into shared memory with row
// stride ld, times `mul`, zeros past t
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int r0, int t,
                                              int d, int ld, float mul) {
  for (int i = threadIdx.x; i < kBlockK * d; i += kThreads) {
    const int r = i / d, c = i % d;
    dst[r * ld + c] = r0 + r < t ? src[(size_t)(r0 + r) * d + c] * mul : 0.f;
  }
}

// Thread (ty, tx) owns query rows ty + 16 * i (i < kRows), keys tx + 16 * j of
// each tile (j < kKeys) and head-dim columns tx + 16 * j (j < kCols). The 16
// threads that share a row sit in one half-warp, so row reductions are
// shuffles. kCols * 16 >= D. The schedules as in the bf16 kernel, in natural
// units (expf): the f32 and bf16 ones take a first pass over the K tiles
// for the row max (and the f32 row sum) before the pass that reads V.
template <int kCols, int kMode, bool kDrop>
__global__ void __launch_bounds__(kThreads)
gated_bias_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ bias,
                                int ldbias, const float* __restrict__ gate, float* __restrict__ out,
                                float* __restrict__ lse,
                                int num_heads, int t, int d, float scale, Dropout dr) {
  extern __shared__ float smem[];
  const int ld = d + 1;  // padded stride: column-strided reads hit distinct banks
  const int ldp = kBlockK + 1;
  float* qs = smem;                  // (kBlockQ, ld), pre-scaled q
  float* ks = qs + kBlockQ * ld;     // (kBlockK, ld)
  float* vs = ks + kBlockK * ld;     // (kBlockK, ld)
  float* ps = vs + kBlockK * ld;     // (kBlockQ, ldp), p of the current tile

  const int bh = blockIdx.x;  // b * num_heads + h
  const int h = bh % num_heads;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int tx = tid % kThreadsX;
  const int ty = tid / kThreadsX;

  const size_t head = (size_t)bh * t * d;
  const float* qh = q + head;
  const float* kh = k + head;
  const float* vh = v + head;
  const float* bias_h = bias + (size_t)h * t * ldbias;
  const float* gate_h = gate + (size_t)bh * t;

  for (int i = tid; i < kBlockQ * d; i += kThreads) {
    const int r = i / d, c = i % d;
    const int row = q0 + r;
    qs[r * ld + c] = row < t ? qh[(size_t)row * d + c] * scale : 0.f;
  }

  float g[kRows], m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kThreadsY * i;
    g[i] = row < t ? gate_h[row] : 0.f;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }
  uint32_t s1 = 0, s2 = 0;
  if (kDrop) dropout_streams(dr.seed, bh / num_heads, h, s1, s2);
  const float keep_scale = kMode == kBf16 ? round_bf16(dr.keep_scale) : dr.keep_scale;

  // K (and V) rows k0 .. k0 + 63 into shared memory, zeros past t
  auto load_keys = [&](int k0, bool with_v) {
    __syncthreads();  // the previous tile's ks, vs and ps are no longer read
    for (int i = tid; i < kBlockK * d; i += kThreads) {
      const int r = i / d, c = i % d;
      const int row = k0 + r;
      const bool valid = row < t;
      ks[r * ld + c] = valid ? kh[(size_t)row * d + c] : 0.f;
      if (with_v) vs[r * ld + c] = valid ? vh[(size_t)row * d + c] : 0.f;
    }
    __syncthreads();
  };
  // this thread's scores of the tile at k0: q k^T + gate bias, keys past t masked
  auto scores = [&](int k0, float (&s)[kRows][kKeys]) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + kThreadsY * i) * ld + c];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = ks[(tx + kThreadsX * j) * ld + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + kThreadsY * i;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int col = k0 + tx + kThreadsX * j;
        if (col >= t) {
          s[i][j] = kMasked;
        } else if (row < t) {
          s[i][j] += g[i] * bias_h[(size_t)row * ldbias + col];
        }
      }
    }
  };
  auto row_max = [&](const float (&s)[kKeys]) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) mx = fmaxf(mx, s[j]);
#pragma unroll
    for (int off = kThreadsX / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    return mx;
  };
  auto row_sum = [&](float x) {
#pragma unroll
    for (int off = kThreadsX / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
  };

  if (kMode != kDeferred) {  // first pass: the row max and, f32, the row sum
    for (int k0 = 0; k0 < t; k0 += kBlockK) {
      load_keys(k0, false);
      float s[kRows][kKeys];
      scores(k0, s);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        // key 0 is valid in the first tile, so m_new is finite from then on
        const float m_new = fmaxf(m[i], row_max(s[i]));
        if (kMode == kF32) {
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < kKeys; ++j) sum += expf(s[i][j] - m_new);
          l[i] = l[i] * expf(m[i] - m_new) + row_sum(sum);
        }
        m[i] = m_new;
      }
    }
  }

  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    load_keys(k0, true);
    float s[kRows][kKeys];
    scores(k0, s);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + kThreadsY * i;
      float corr = 1.f;
      if (kMode == kDeferred) {  // the running max; o and l rescaled
        const float m_new = fmaxf(m[i], row_max(s[i]));
        corr = expf(m[i] - m_new);
        m[i] = m_new;
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        float p;
        if (kMode == kF32) {
          p = expf(s[i][j] - m[i]) / l[i];
        } else if (kMode == kBf16) {
          p = round_bf16(expf(round_bf16(s[i][j] - m[i])));
          sum += p;
        } else {
          p = expf(s[i][j] - m[i]);
          sum += p;
        }
        if (kDrop) {
          const float keep = dropout_keep<true>(s1, s2, row, k0 + tx + kThreadsX * j, dr);
          p = keep == 0.f ? 0.f : kMode == kBf16 ? round_bf16(p * keep_scale) : p * keep;
        }
        ps[(ty + kThreadsY * i) * ldp + tx + kThreadsX * j] = p;
      }
      if (kMode != kF32) l[i] = l[i] * corr + row_sum(sum);
      if (kMode == kDeferred) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
      }
    }
    __syncthreads();

    const int keys = min(kBlockK, t - k0);
    for (int c = 0; c < keys; ++c) {
      float vv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + kThreadsX * j;
        vv[j] = col < d ? vs[c * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = ps[(ty + kThreadsY * i) * ldp + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kThreadsY * i;
    if (row >= t) continue;
    const float inv = kMode == kF32 ? 1.f : 1.f / l[i];
    if (lse != nullptr && tx == 0) lse[(size_t)bh * t + row] = m[i] + logf(l[i]);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + kThreadsX * j;
      if (col < d) out[head + (size_t)row * d + col] = acc[i][j] * inv;
    }
  }
}

// K2 pass A, float32: one block per (head, 64 query rows, batch chunk),
// looping over the chunk's batch elements. Thread layout as in the forward.
template <int kCols, bool kDrop>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ bias,
                            int ldbias, const float* __restrict__ gate,
                            const float* __restrict__ out, const float* __restrict__ dout,
                            const float* __restrict__ lse, float* __restrict__ delta,
                            float* __restrict__ dq, float* __restrict__ dgate,
                            float* __restrict__ dbias_part, int ldb,
                            int batch, int num_heads, int t, int d, float scale, Dropout dr) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int ldp = kBlockK + 1;
  float* qs = smem;                // (64, ld), pre-scaled q
  float* dos = qs + kBlockQ * ld;  // (64, ld)
  float* ks = dos + kBlockQ * ld;  // (64, ld)
  float* vs = ks + kBlockK * ld;   // (64, ld)
  float* dss = vs + kBlockK * ld;  // (64, ldp), dS of the current tile

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int tx = tid % kThreadsX, ty = tid / kThreadsX;
  const int b0 = blockIdx.z * batch / gridDim.z, b1 = (blockIdx.z + 1) * batch / gridDim.z;
  const float* bias_h = bias + (size_t)h * t * ldbias;
  float* part = dbias_part + ((size_t)blockIdx.z * num_heads + h) * t * ldb;

  for (int b = b0; b < b1; ++b) {
    const int bh = b * num_heads + h;
    const size_t head = (size_t)bh * t * d;
    __syncthreads();
    load_tile_f32(qs, q + head, q0, t, d, ld, scale);
    load_tile_f32(dos, dout + head, q0, t, d, ld, 1.f);
    __syncthreads();

    float g[kRows], ls[kRows], dl[kRows], dg[kRows], acc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kThreadsY * i, row = q0 + r;
      const bool valid = row < t;
      g[i] = valid ? gate[(size_t)bh * t + row] : 0.f;
      ls[i] = valid ? lse[(size_t)bh * t + row] : 0.f;
      float part = 0.f;  // D = rowsum(dO * O)
      if (valid)
        for (int c = tx; c < d; c += kThreadsX) part += out[head + (size_t)row * d + c] * dos[r * ld + c];
#pragma unroll
      for (int off = kThreadsX / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      dl[i] = part;
      if (valid && tx == 0) delta[(size_t)bh * t + row] = part;
      dg[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
    }
    uint32_t s1 = 0, s2 = 0;
    if (kDrop) dropout_streams(dr.seed, b, h, s1, s2);

    for (int k0 = 0; k0 < t; k0 += kBlockK) {
      __syncthreads();  // the previous tile's ks and dss are no longer read
      load_tile_f32(ks, k + head, k0, t, d, ld, 1.f);
      load_tile_f32(vs, v + head, k0, t, d, ld, 1.f);
      __syncthreads();

      float s[kRows][kKeys], dp[kRows][kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < d; ++c) {
        float qv[kRows], dov[kRows], kv[kKeys], vv[kKeys];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          qv[i] = qs[(ty + kThreadsY * i) * ld + c];
          dov[i] = dos[(ty + kThreadsY * i) * ld + c];
        }
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          kv[j] = ks[(tx + kThreadsX * j) * ld + c];
          vv[j] = vs[(tx + kThreadsX * j) * ld + c];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kKeys; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ty + kThreadsY * i, row = q0 + r;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          const int kj = tx + kThreadsX * j, col = k0 + kj;
          float ds = 0.f;
          if (col < t && row < t) {
            const float pb = bias_h[(size_t)row * ldbias + col];
            const float w = expf(s[i][j] + g[i] * pb - ls[i]);
            ds = w * (dp[i][j] * dropout_keep<kDrop>(s1, s2, row, col, dr) - dl[i]);
            dg[i] += ds * pb;
            const float contrib = g[i] * ds;
            float* at = part + (size_t)row * ldb + col;
            *at = b == b0 ? contrib : *at + contrib;
          }
          dss[r * ldp + kj] = ds;
        }
      }
      __syncthreads();

      const int keys = min(kBlockK, t - k0);
      for (int c = 0; c < keys; ++c) {
        float kv[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int col = tx + kThreadsX * j;
          kv[j] = col < d ? ks[c * ld + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float ds = dss[(ty + kThreadsY * i) * ldp + c];
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + kThreadsY * i;
#pragma unroll
      for (int off = kThreadsX / 2; off > 0; off >>= 1)
        dg[i] += __shfl_xor_sync(0xffffffffu, dg[i], off);
      if (row >= t) continue;
      if (tx == 0) dgate[(size_t)bh * t + row] = dg[i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + kThreadsX * j;
        if (col < d) dq[head + (size_t)row * d + col] = acc[i][j] * scale;
      }
    }
  }
}

// K2 pass B, float32: one block per (batch, head, 64 keys). Thread (ty, tx)
// owns keys ty + 16 * i, query columns tx + 16 * j of each query tile and
// head-dim columns tx + 16 * j.
template <int kCols, bool kDrop>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ bias,
                              int ldbias, const float* __restrict__ gate,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int num_heads, int t, int d, float scale, Dropout dr) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int ldp = kBlockQ + 1;
  float* ks = smem;                 // (64, ld)
  float* vs = ks + kBlockK * ld;    // (64, ld)
  float* qs = vs + kBlockK * ld;    // (64, ld), pre-scaled q
  float* dos = qs + kBlockQ * ld;   // (64, ld)
  float* wss = dos + kBlockQ * ld;  // (64 keys, ldp): W * m
  float* dss = wss + kBlockK * ldp; // (64 keys, ldp): dS
  float* lse_s = dss + kBlockK * ldp;
  float* delta_s = lse_s + kBlockQ;
  float* gate_s = delta_s + kBlockQ;

  const int bh = blockIdx.x;
  const int b = bh / num_heads, h = bh % num_heads;
  const int k0 = blockIdx.y * kBlockK;
  const int tid = threadIdx.x;
  const int tx = tid % kThreadsX, ty = tid / kThreadsX;
  const size_t head = (size_t)bh * t * d;
  const float* bias_h = bias + (size_t)h * t * ldbias;

  load_tile_f32(ks, k + head, k0, t, d, ld, 1.f);
  load_tile_f32(vs, v + head, k0, t, d, ld, 1.f);
  uint32_t s1 = 0, s2 = 0;
  if (kDrop) dropout_streams(dr.seed, b, h, s1, s2);
  float dka[kRows][kCols], dva[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int q0 = 0; q0 < t; q0 += kBlockQ) {
    __syncthreads();
    load_tile_f32(qs, q + head, q0, t, d, ld, scale);
    load_tile_f32(dos, dout + head, q0, t, d, ld, 1.f);
    if (tid < kBlockQ) {
      const bool valid = q0 + tid < t;
      const size_t at = (size_t)bh * t + q0 + tid;
      lse_s[tid] = valid ? lse[at] : 0.f;
      delta_s[tid] = valid ? delta[at] : 0.f;
      gate_s[tid] = valid ? gate[at] : 0.f;
    }
    __syncthreads();

    float st[kRows][kKeys], dpt[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float kv[kRows], vv[kRows], qv[kKeys], dov[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        kv[i] = ks[(ty + kThreadsY * i) * ld + c];
        vv[i] = vs[(ty + kThreadsY * i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        qv[j] = qs[(tx + kThreadsX * j) * ld + c];
        dov[j] = dos[(tx + kThreadsX * j) * ld + c];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], dov[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int ki = ty + kThreadsY * i, key = k0 + ki;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int qi = tx + kThreadsX * j, qrow = q0 + qi;
        float wd = 0.f, ds = 0.f;
        if (qrow < t && key < t) {
          const float pb = bias_h[(size_t)qrow * ldbias + key];
          const float w = expf(st[i][j] + gate_s[qi] * pb - lse_s[qi]);
          const float keep = dropout_keep<kDrop>(s1, s2, qrow, key, dr);
          wd = w * keep;
          ds = w * (dpt[i][j] * keep - delta_s[qi]);
        }
        wss[ki * ldp + qi] = wd;
        dss[ki * ldp + qi] = ds;
      }
    }
    __syncthreads();

    const int rows = min(kBlockQ, t - q0);
    for (int c = 0; c < rows; ++c) {
      float qv[kCols], dov[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + kThreadsX * j;
        qv[j] = col < d ? qs[c * ld + col] : 0.f;
        dov[j] = col < d ? dos[c * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float wd = wss[(ty + kThreadsY * i) * ldp + c];
        const float ds = dss[(ty + kThreadsY * i) * ldp + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          dva[i][j] = fmaf(wd, dov[j], dva[i][j]);
          dka[i][j] = fmaf(ds, qv[j], dka[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = k0 + ty + kThreadsY * i;
    if (key >= t) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + kThreadsX * j;
      if (col < d) {
        dk[head + (size_t)key * d + col] = dka[i][j];
        dv[head + (size_t)key * d + col] = dva[i][j];
      }
    }
  }
}

// dbias[i] = sum over the chunks z = 0 .. chunks - 1, in that order, of the
// partial slices part[z] (rows of length ldb >= t): n = rows * t elements.
__global__ void dbias_sum_kernel(const float* __restrict__ part, float* __restrict__ dbias,
                                 int chunks, int rows, int t, int ldb) {
  const size_t n = (size_t)rows * t;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / t, c = i % t;
    float acc = part[r * ldb + c];
    for (int z = 1; z < chunks; ++z) acc += part[((size_t)z * rows + r) * ldb + c];
    dbias[i] = acc;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D bf16 tensor map (cols, rows, mats) with row and matrix strides in
// elements, boxes of (box_cols, box_rows, 1) in the 128B-swizzled layout;
// elements outside the tensor read as zeros. 0 or -1000 - the driver's error.
int encode_3d(const EncodeTiled encode, CUtensorMap* map, const void* ptr, int cols, int rows,
              int mats, size_t row_stride, size_t mat_stride, int box_cols, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride * 2, (cuuint64_t)mat_stride * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - (int)r;
}

template <int kDim, int kMode, bool kDrop>
int launch_forward_bf16(const void* q, const void* k, const void* v, const void* bias,
                        int ldbias, const float* gate, void* out, float* lse, int b, int h,
                        int t, int d, float scale, Dropout dr, cudaStream_t s) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  CUtensorMap q_map, k_map, v_map, bias_map;
  int rc;
  // q, k, v: (d, t, b h) with boxes of 64 columns by a block's rows or a key tile
  if ((rc = encode_3d(encode, &q_map, q, d, t, b * h, d, (size_t)t * d, 64, kFwdRows)) != 0 ||
      (rc = encode_3d(encode, &k_map, k, d, t, b * h, d, (size_t)t * d, 64, kBlockK)) != 0 ||
      (rc = encode_3d(encode, &v_map, v, d, t, b * h, d, (size_t)t * d, 64, kBlockK)) != 0 ||
      // the bias: (t keys, t rows, h) in rows of ldbias; keys past t read as zeros
      (rc = encode_3d(encode, &bias_map, bias, t, t, h, ldbias, (size_t)t * ldbias, kBlockK,
                      kFwdRows)) != 0)
    return rc;
  auto kernel = gated_bias_attention_bf16_kernel<kDim, kMode, kDrop>;
  const size_t smem = FwdLayout<kDim>::kSmem;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + kFwdRows - 1) / kFwdRows, b * h);
  kernel<<<grid, kFwdThreads, smem, s>>>(q_map, k_map, v_map, bias_map, gate,
                                         static_cast<__nv_bfloat16*>(out), lse, h, t, d, scale,
                                         dr);
  return (int)cudaGetLastError();
}

template <int kCols, int kMode, bool kDrop>
int launch_forward_f32(const void* q, const void* k, const void* v, const void* bias,
                       int ldbias, const float* gate, void* out, float* lse, int b, int h,
                       int t, int d, float scale, Dropout dr, cudaStream_t s) {
  auto kernel = gated_bias_attention_f32_kernel<kCols, kMode, kDrop>;
  const size_t smem = sizeof(float) * ((size_t)(kBlockQ + 2 * kBlockK) * (d + 1) +
                                       (size_t)kBlockQ * (kBlockK + 1));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * h, (t + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), ldbias, gate, static_cast<float*>(out), lse, h, t, d,
      scale, dr);
  return (int)cudaGetLastError();
}

using ForwardLaunch = int (*)(const void*, const void*, const void*, const void*, int,
                              const float*, void*, float*, int, int, int, int, float, Dropout,
                              cudaStream_t);

// The instance of (schedule, dropout) at a head dim (bf16: 64 or 128) or a
// column count (f32: 4 or 8): each schedule without the mask, and the f32
// schedule with it (the training forward; no path runs inference with
// dropout in another schedule). A schedule's number is its template
// argument, so table[mode] runs schedule mode; nullptr: no such instance.
template <int kDim, int... kModes>
ForwardLaunch forward_bf16(int mode, int dropout, std::integer_sequence<int, kModes...>) {
  static const ForwardLaunch table[] = {launch_forward_bf16<kDim, kModes, false>...};
  if (dropout) return mode == kF32 ? launch_forward_bf16<kDim, kF32, true> : nullptr;
  return table[mode];
}

template <int kCols, int... kModes>
ForwardLaunch forward_f32(int mode, int dropout, std::integer_sequence<int, kModes...>) {
  static const ForwardLaunch table[] = {launch_forward_f32<kCols, kModes, false>...};
  if (dropout) return mode == kF32 ? launch_forward_f32<kCols, kF32, true> : nullptr;
  return table[mode];
}

using Schedules = std::make_integer_sequence<int, kBf16 + 1>;  // kF32, kDeferred, kBf16

}  // namespace

// q, k, v, out: (b, h, t, d) contiguous, float32 (is_bf16 == 0) or bfloat16,
// 16-byte aligned; bias: (h, t, t) in the same type, rows of ldbias elements
// (ldbias >= t, a multiple of 8, heads t * ldbias apart, 16-byte aligned);
// gate: (b, h, t) float32; d <= 128 and a multiple of 8. mode: the softmax
// schedule (0 f32, 1 deferred, 2 bf16). dropout != 0: the instance with the
// mask of (seed, threshold, keep_scale), f32 schedule only (any other is
// refused); 0: the instance without it. lse:
// (b, h, t) float32 row log-sum-exp, written when not null (the training
// forward, f32 schedule).
// Returns the CUDA error of the launch (0 on success), -1 when the driver
// has no cuTensorMapEncodeTiled, -1000 - the driver's error when a tensor
// map is refused.
extern "C" int gated_bias_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* bias, int ldbias, const void* gate,
                                        void* out, void* lse, int b, int h, int t, int d,
                                        int is_bf16, int mode, int dropout, uint32_t seed,
                                        uint32_t threshold, float keep_scale, void* stream) {
  if (mode < 0 || mode > kBf16) return (int)cudaErrorInvalidValue;
  const ForwardLaunch launch =
      is_bf16 ? (d <= 64 ? forward_bf16<64>(mode, dropout, Schedules{})
                         : forward_bf16<128>(mode, dropout, Schedules{}))
              : (d <= 64 ? forward_f32<4>(mode, dropout, Schedules{})
                         : forward_f32<8>(mode, dropout, Schedules{}));
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  return launch(q, k, v, bias, ldbias, static_cast<const float*>(gate), out,
                static_cast<float*>(lse), b, h, t, d, 1.0f / sqrtf((float)d),
                Dropout{seed, threshold, keep_scale}, static_cast<cudaStream_t>(stream));
}

// K1's bf16 blocks (every instance) for head dim d: writes the dynamic
// shared memory of a block to *smem and returns the blocks one SM of the
// current device holds at once (the deferred instance without dropout, the
// serving one), or minus the CUDA error.
extern "C" int gated_bias_attention_fwd_bf16_occupancy(int d, int* smem) {
  auto kernel = d <= 64 ? gated_bias_attention_bf16_kernel<64, kDeferred, false>
                        : gated_bias_attention_bf16_kernel<128, kDeferred, false>;
  const size_t bytes = d <= 64 ? FwdLayout<64>::kSmem : FwdLayout<128>::kSmem;
  *smem = (int)bytes;
  cudaError_t err = allow_smem(kernel, bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kFwdThreads, bytes);
  return err != cudaSuccess ? -(int)err : blocks;
}

// Pass A's shared memory. bf16 (dim 64 or 128): the q and dO tiles, two K,
// two V and two bias tiles. f32: the q, dO, K and V tiles and the dS tile.
static size_t pass_a_smem_bf16(int dim) {
  return sizeof(__nv_bfloat16) * ((size_t)(2 * kBlockQ + 4 * kBlockK) * (dim + 8) +
                                  2 * (size_t)kBlockQ * (kBlockK + 8));
}

static size_t pass_a_smem_f32(int d) {
  return sizeof(float) * ((size_t)(2 * kBlockQ + 2 * kBlockK) * (d + 1) +
                          (size_t)kBlockQ * (kBlockK + 1));
}

template <bool kDrop>
static int pass_a_blocks_per_sm(int d, int is_bf16) {
  int blocks = 0;
  cudaError_t err;
  if (is_bf16) {
    auto pass_a = d <= 64 ? attention_bwd_dq_bf16_kernel<64, kDrop>
                          : attention_bwd_dq_bf16_kernel<128, kDrop>;
    const size_t smem = pass_a_smem_bf16(d <= 64 ? 64 : 128);
    if ((err = allow_smem(pass_a, smem)) != cudaSuccess) return -(int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pass_a, kWarps * 32, smem);
  } else {
    auto pass_a = d <= 64 ? attention_bwd_dq_f32_kernel<4, kDrop>
                          : attention_bwd_dq_f32_kernel<8, kDrop>;
    const size_t smem = pass_a_smem_f32(d);
    if ((err = allow_smem(pass_a, smem)) != cudaSuccess) return -(int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pass_a, kThreads, smem);
  }
  return err != cudaSuccess ? -(int)err : blocks;
}

// Blocks of pass A (the instance with dropout != 0 or without) that one SM
// of the current device holds at once (its registers and shared memory
// decide), or minus the CUDA error. The plan that splits the batch into
// chunks counts the card's resident blocks so.
extern "C" int gated_bias_attention_bwd_a_blocks_per_sm(int d, int is_bf16, int dropout) {
  return dropout ? pass_a_blocks_per_sm<true>(d, is_bf16) : pass_a_blocks_per_sm<false>(d, is_bf16);
}

template <bool kDrop>
static cudaError_t launch_pass_a(const void* q, const void* k, const void* v, const void* bias,
                                 int ldbias, const float* gate, const void* out, const void* dout,
                                 const float* lse, float* delta, void* dq, float* dgate,
                                 float* part, int b, int h, int t, int d, int is_bf16, int chunks,
                                 int ldb, Dropout dr, cudaStream_t s) {
  const dim3 grid(h, (t + kBlockQ - 1) / kBlockQ, chunks);
  const float scale = 1.0f / sqrtf((float)d);
  cudaError_t err;
  if (is_bf16) {
    using bf16 = __nv_bfloat16;
    auto pass_a = d <= 64 ? attention_bwd_dq_bf16_kernel<64, kDrop>
                          : attention_bwd_dq_bf16_kernel<128, kDrop>;
    const size_t smem = pass_a_smem_bf16(d <= 64 ? 64 : 128);
    if ((err = allow_smem(pass_a, smem)) != cudaSuccess) return err;
    pass_a<<<grid, kWarps * 32, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(bias), ldbias, gate, static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dq), dgate, part, ldb, b, h, t, d, scale, dr);
  } else {
    auto pass_a = d <= 64 ? attention_bwd_dq_f32_kernel<4, kDrop>
                          : attention_bwd_dq_f32_kernel<8, kDrop>;
    const size_t smem = pass_a_smem_f32(d);
    if ((err = allow_smem(pass_a, smem)) != cudaSuccess) return err;
    pass_a<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(bias), ldbias, gate, static_cast<const float*>(out),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), dgate, part,
        ldb, b, h, t, d, scale, dr);
  }
  return cudaGetLastError();
}

// K2 pass A and the sum, for the backward of gated_bias_attention_fwd's
// training forward with the same dropout arguments (dropout == 0: the
// instance without the mask replay). Inputs: q, k, v, bias (h, t, ldbias)
// with ldbias >= t a multiple of 8 and zeros past t, gate, out, dout (out's
// cotangent), lse; outputs: delta (b, h, t) float32 (D, for pass B),
// dq in q's type, dgate (b, h, t) and dbias (h, t, t) in float32; scratch:
// dbias_part (chunks, h, t, ldb) float32 with ldb >= t, ldb % 4 == 0 (rows
// 16-byte aligned). The batch is split into `chunks` <= b chunks of
// consecutive elements, chunk z holding z b / chunks .. (z + 1) b / chunks - 1.
// Launches pass A, then the sum, on the same stream. Returns the first CUDA
// error (0 on success).
extern "C" int gated_bias_attention_bwd_a(const void* q, const void* k, const void* v,
                                          const void* bias, int ldbias, const void* gate,
                                          const void* out,
                                          const void* dout, const void* lse, void* delta, void* dq,
                                          void* dgate, void* dbias_part, void* dbias, int b,
                                          int h, int t, int d, int is_bf16, int chunks, int ldb,
                                          int dropout, uint32_t seed, uint32_t threshold,
                                          float keep_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{seed, threshold, keep_scale};
  float* part = static_cast<float*>(dbias_part);
  auto launch = dropout ? launch_pass_a<true> : launch_pass_a<false>;
  cudaError_t err = launch(q, k, v, bias, ldbias, static_cast<const float*>(gate), out, dout,
                           static_cast<const float*>(lse), static_cast<float*>(delta), dq,
                           static_cast<float*>(dgate), part, b, h, t, d, is_bf16, chunks, ldb,
                           dr, s);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)h * t * t;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  dbias_sum_kernel<<<blocks, 256, 0, s>>>(part, static_cast<float*>(dbias), chunks, h * t, t,
                                          ldb);
  return (int)cudaGetLastError();
}

template <bool kDrop>
static cudaError_t launch_pass_b(const void* q, const void* k, const void* v, const void* bias,
                                 int ldbias, const float* gate, const void* dout,
                                 const float* lse, const float* delta, void* dk, void* dv, int b,
                                 int h, int t, int d, int is_bf16, Dropout dr, cudaStream_t s) {
  const dim3 grid(b * h, (t + kBlockK - 1) / kBlockK);
  const float scale = 1.0f / sqrtf((float)d);
  cudaError_t err;
  if (is_bf16) {
    using bf16 = __nv_bfloat16;
    const int dim = d <= 64 ? 64 : 128;
    auto pass_b = d <= 64 ? attention_bwd_dkdv_bf16_kernel<64, kDrop>
                          : attention_bwd_dkdv_bf16_kernel<128, kDrop>;
    const size_t smem = sizeof(bf16) * ((size_t)(2 * kBlockQ + 2 * kBlockK) * (dim + 8) +
                                        (size_t)kBlockQ * (kBlockK + 8)) +
                        sizeof(float) * 3 * kBlockQ;
    if ((err = allow_smem(pass_b, smem)) != cudaSuccess) return err;
    pass_b<<<grid, kWarps * 32, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(bias), ldbias, gate, static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), h, t, d, scale, dr);
  } else {
    auto pass_b = d <= 64 ? attention_bwd_dkdv_f32_kernel<4, kDrop>
                          : attention_bwd_dkdv_f32_kernel<8, kDrop>;
    const size_t smem = sizeof(float) * ((size_t)(2 * kBlockQ + 2 * kBlockK) * (d + 1) +
                                         2 * (size_t)kBlockK * (kBlockQ + 1) + 3 * kBlockQ);
    if ((err = allow_smem(pass_b, smem)) != cudaSuccess) return err;
    pass_b<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(bias), ldbias, gate, static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), h, t, d, scale, dr);
  }
  return cudaGetLastError();
}

// K2 pass B: dk, dv in q's type from q, k, v, bias (rows of ldbias), gate,
// dout, lse and the delta that pass A wrote, with the same dropout
// arguments. Returns the CUDA error of the launch (0 on success).
extern "C" int gated_bias_attention_bwd_b(const void* q, const void* k, const void* v,
                                          const void* bias, int ldbias, const void* gate,
                                          const void* dout,
                                          const void* lse, const void* delta, void* dk, void* dv,
                                          int b, int h, int t, int d, int is_bf16, int dropout,
                                          uint32_t seed, uint32_t threshold, float keep_scale,
                                          void* stream) {
  auto launch = dropout ? launch_pass_b<true> : launch_pass_b<false>;
  return (int)launch(q, k, v, bias, ldbias, static_cast<const float*>(gate), dout,
                     static_cast<const float*>(lse), static_cast<const float*>(delta), dk, dv, b,
                     h, t, d, is_bf16, Dropout{seed, threshold, keep_scale},
                     static_cast<cudaStream_t>(stream));
}
