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
// launches, each an entry point of its own, that need no atomics:
//  * pass A (dq, dgate, a partial dbias, D): one block per (head, 64 query
//    rows, batch chunk). The wrapper splits the batch into S chunks of
//    consecutive elements (pass_a_chunks): S walks the fewest batch
//    elements per block slot (rounds of resident blocks times the elements
//    of the largest chunk), which one element a chunk always does, so S = B
//    wherever B slices fit in a 32nd of the card's memory (2.5 GB on an 80
//    GB card: every path's shape) and the walk decides below that cap. A block loops over its chunk's batch
//    elements in order and, for each, twice over the 64-key tiles: first for
//    D (in bf16 also the keep bits), then for dS. It owns its rows of its
//    chunk's f32 dbias slice (S, H, T, ldb) in scratch for the whole call
//    and adds each batch element's tile in place (float2 pairs: a lane of
//    the wgmma accumulator owns two neighbouring columns). dq, dgate and D
//    are per (batch, head, row) and written by the chunk that owns the
//    batch element.
//  * the sum: dbias = the S slices added in chunk order, one thread per
//    element: a fixed order, so dbias is the same bit for bit from call to
//    call.
//  * pass B (dk, dv): one block per (batch, head, 64 keys) loops over the
//    query tiles, FlashAttention-2 style without dq, with the row values
//    pass A wrote (bf16: gate, lse and D packed per row; f32: lse and D).
// Keys past T get dS = 0 and W = 0; query rows past T contribute nothing.
// The dropout mask is hashed once per score in the bf16 backward: pass A's
// first sweep hashes it while its products run, keeps the lane's bits in
// shared memory for the second sweep and writes them packed, 64 bits per
// row and key block ((B H, T/64 key blocks, 64 T/64 rows, 2) uint32, 4.8 MB
// at the training shape, zero past T), for pass B, which reads a tile's
// 512 bytes with its other tiles and hashes nothing. The f32 instances
// replay the hash in both passes.
//
// Bound on an H100 at WavLM-Base training shapes (B 16, H 12, T 399, D 64,
// bf16): K1 moves about 44 MB (q, k, v, o, bias, gate, lse) against 7.8
// GFLOP, K2 about 81 MB (q, k, v, dO read, dq, dk, dv written, the bias,
// gate and lse read, dbias written in f32; not o, since D is the TPU
// kernel's r) against 19.6 GFLOP of the five products it needs; at 3.35
// TB/s and 989 TFLOP/s both are bound by bytes (K1: 13.0 us, K2: 24.2
// us). K1's inference instance at the unpruned `base` model's shape (B 32,
// H 12) moves 82.9 MB against 15.6 GFLOP: 24.7 us by bytes. The dropout
// instances also have an issue-rate floor, 30.6 M scores at that shape at
// 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz: K1's training instance
// about 30 instructions per score (19 of them the dropout hash), about 27
// us; K2's bf16 passes about 55 per score in all (the hash once, then about
// 5 for W, 3 for the mask, 3 for D or dS and 2 for dgate and dbias in each
// of pass A's two sweeps and pass B), about 50 us, twice its byte bound.
// The split adds the S partial slices (16 x 7.6 MB written and read at that
// shape, more than the 50 MB L2).
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
// K2, bfloat16 (every instance; sm_90a):
//  * A block is one warpgroup (128 threads) of 64 rows: query rows in pass
//    A, keys in pass B. One warpgroup keeps a block's registers to one
//    accumulator set: pass A holds s, dW' and dq (96 f32 a thread), pass B
//    s^T, dW'^T, dk and dv (128); blocks an SM: pass A 3 (168 registers at
//    D 64, its launch bound, with 48 bytes spilled by the dropout instance:
//    2 blocks without the spill measured 3-9% slower), pass B 2 (210-227).
//    A third ring stage, in either pass, measured no faster.
//  * Every product on wgmma m64n64k16 (f32 accumulate): s = Q K^T and dW' =
//    dO V^T (pass B: s^T = K Q^T and dW'^T = V dO^T) with both operands
//    K-major from shared memory; dq += dS K, dv += (W m)^T dO and dk +=
//    dS^T Q with the A operand in registers (the accumulator rounded to bf16
//    in place, the A layout, as K1's p) and the B tile MN-major, as K1's V.
//  * Tiles arrive by TMA in the 128B-swizzled layout, from 3-D tensor maps
//    per (b h) and per head (rows and keys past T read as zeros), into a
//    two-stage ring behind full / empty mbarriers: pass A stages Q and dO
//    once per batch element and streams K, V and the 64 x 64 bias tile;
//    pass B stages K and V once and streams Q, dO, the bias tile, the 64
//    rows' (gate log2 e, lse log2 e, D, 0) and their keep words (bulk
//    copies). Thread 0 issues every load and refills a slot once the four
//    warps have released it, as in K1.
//  * W = 2^(s c1 + g2 bias - l2) in base 2 (ex2.approx), c1 = log2(e) /
//    sqrt(D), g2 and l2 the gate and lse times log2(e); pass A writes them
//    per row so that pass B reads them with its tiles; rows past T get l2 =
//    inf, so W = 0 there without a test. The bias tile reaches the lanes
//    through ldmatrix (transposed in pass B, whose accumulator columns are
//    the tile's rows), four instructions a tile.
//
// The float32 instances of K1 and K2: 256 threads on the CUDA cores in f32,
// exact for f32 inputs, 64-row tiles staged in shared memory, rows past T
// zero-filled when a tile is staged, keys past T masked in the kernel. K1
// there has the three schedules too (f32 and deferred differ only by
// reassociation for f32 inputs; bf16 still rounds the scores), with a first
// pass over the K tiles in the f32 and bf16 schedules.
// K2's passes have instances without the dropout mask for rate 0.

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

// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %4, 0;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n}\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar)), "r"((uint32_t)pred)
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// ---------------------------------------------------------------------------
// K2, bfloat16: TMA ring, wgmma (every product), one warpgroup a block

constexpr int kBwdThreads = 128;  // one warpgroup: 64 query rows (pass A) or keys (pass B)
constexpr int kStagesA = 2;       // ring depth of pass A
constexpr int kStagesB = 2;       // and of pass B

// Four 8x8 b16 matrices from shared memory: lane l gives the address of row
// l % 8 of matrix l / 8 and receives, per matrix, row l / 4 and columns
// 2 (l % 4), + 1 (kTrans: rows 2 (l % 4), + 1 of column l / 4).
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  if (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(smem)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(smem)));
}

// The 64 x 64 bias tile of a ring stage (64 rows of 128 bytes, 128B-
// swizzled: 16-byte chunk k of row r at chunk k ^ (r % 8)) in the lane's
// accumulator layout: br[2 j + i] holds the bf16 pair of entries 4 j + 2 i
// and + 1 (row 16 warp + 8 i + lane / 4, columns 8 j + 2 (lane % 4), + 1).
// Pass A's rows are the tile's rows (query rows); pass B's are its columns
// (keys), read transposed: its accumulator rows are keys, its columns query
// rows.
template <bool kTrans>
__device__ __forceinline__ void bias_fragments(uint32_t (&br)[16], const unsigned char* tile,
                                               int warp, int lane) {
  const int m = lane / 8, r = lane % 8, i = m % 2;
#pragma unroll
  for (int jb = 0; jb < 8; jb += 2) {
    const int j = jb + m / 2;
    const int row = kTrans ? 8 * j + r : 16 * warp + 8 * i + r;
    const int chunk = kTrans ? 2 * warp + i : j;
    ldmatrix_x4<kTrans>(br + 2 * jb, tile + row * 128 + ((chunk ^ r) * 16));
  }
}

__device__ __forceinline__ float bias_value(const uint32_t (&br)[16], int j, int i, int e) {
  const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&br[2 * j + i]);
  return e == 0 ? __low2float(p) : __high2float(p);
}

// a = A . B^T over the head dim, A and B K-major tiles of 64 rows: A's
// descriptors per 64-column half, B's tile of kDim / 64 halves of 64 rows x
// 128 bytes. Issued, not committed.
template <int kDim>
__device__ __forceinline__ void issue_rows_by_tile(float (&a)[32], const uint64_t (&ad)[kDim / 64],
                                                   const unsigned char* b_tile) {
#pragma unroll
  for (int st = 0; st < kDim / 16; ++st) {
    const uint64_t bd = sw128_desc(b_tile + (st / 4) * 64 * 128);
    if (st == 0)
      wgmma_ss_first(a, ad[0], bd);
    else
      wgmma_ss(a, ad[st / 4] + 2 * (st % 4), bd + 2 * (st % 4), 1u);
  }
}

// acc[hf] += P (64 x 64, bf16 in registers: the A layout) . B (64 x kDim:
// the tile's 64 rows along K, MN-major), issued, not committed
template <int kDim>
__device__ __forceinline__ void issue_acc_by_tile(float (&acc)[kDim / 64][32], const uint32_t (&p)[16],
                                                  const unsigned char* b_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // 16 rows of the tile per step
#pragma unroll
    for (int hf = 0; hf < kDim / 64; ++hf)
      wgmma_rs(acc[hf], p + 4 * kk, sw128_mn_desc(b_tile + hf * 64 * 128) + 128 * kk);
}

// an accumulator tile rounded to bf16 in the A layout of the next product
__device__ __forceinline__ void pack_a(uint32_t (&p)[16], const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[4 * kk + e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// Bits of a packed keep mask (the layout pass A writes): keep[(bh, key
// block kb, row r, word w)] holds bit k % 32 = keep(r, 64 kb + 32 w + k % 32)
// for r < round_up(t, 64); zero past t in either direction.
__device__ __forceinline__ size_t keep_word(int bh, int kb, int tiles, int r) {
  return (((size_t)bh * tiles + kb) * (tiles * 64) + r) * 2;
}

// pass A's lane keep bits (keep_bits' layout) as the two packed words of
// row `i` of the lane: word w holds keys 32 w .. 32 w + 31 of the tile; each
// lane holds 16 of a row's 64 bits, so the four lanes of the row group are
// or-ed together
__device__ __forceinline__ void packed_words(uint32_t (&wd)[2][2], uint32_t keep, int c) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      uint32_t x = 0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          x |= ((keep >> (4 * (4 * w + jj) + 2 * i + e)) & 1u) << (8 * jj + 2 * c + e);
      x |= __shfl_xor_sync(0xffffffffu, x, 1);
      x |= __shfl_xor_sync(0xffffffffu, x, 2);
      wd[i][w] = x;
    }
}

// Shared memory of a pass A block from a 1024-aligned base: Q and dO
// (kDim / 64 halves of 64 rows x 128 bytes each), the ring (K, V, the 64 x
// 64 bias tile per stage), the barriers, then with dropout the lane keep
// bits of a batch element (one word per lane and key tile).
template <int kDim>
struct BwdALayout {
  static constexpr uint32_t kTileBytes = 64 * kDim * 2;
  static constexpr uint32_t kBiasBytes = 64 * kBlockK * 2;
  static constexpr uint32_t kStageBytes = 2 * kTileBytes + kBiasBytes;
  static constexpr uint32_t kRing = 2 * kTileBytes;
  static constexpr uint32_t kBars = kRing + kStagesA * kStageBytes;
  static constexpr uint32_t kBits = kBars + 128;
  static size_t smem(int t, bool drop) {
    return kBits + (drop ? (size_t)(t + 63) / 64 * kBwdThreads * 4 : 0) + 1024;
  }
};

// The scores of one tile in base 2 (x = s c1 + g2 bias - l2, keys past t
// masked when kTail) and their weights W = 2^x, in place.
template <bool kTail>
__device__ __forceinline__ void tile_weights_bwd(float (&s)[32], const uint32_t (&br)[16],
                                                 float c1, const float (&g2)[2],
                                                 const float (&l2)[2], int col0, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * i + e];
        const float w = ex2(fmaf(x, c1, g2[i] * bias_value(br, j, i, e)) - l2[i]);
        x = kTail && col0 + 8 * j + e >= t ? 0.f : w;
      }
}

// K2 pass A, bf16: one block (a warpgroup) per (head, 64 query rows, batch
// chunk), looping over the chunk's batch elements and, for each, twice over
// the 64-key tiles. Per tile: s = Q K^T and dW' = dO V^T on wgmma, W = 2^(s
// c1 + g2 bias - l2) in registers. The first sweep hashes the keep mask
// (while the products run), keeps the lane's bits in shared memory, writes
// the packed mask for pass B, and sums D = rowsum(W * dW' * m), the TPU
// kernel's r, from the exact f32 W. The second reads the bits back, makes
// dS = W (dW' m - D) and adds dS K (dS rounded to bf16 in the accumulator's
// registers, the K tile MN-major), dgate and gate * dS into the chunk's f32
// d pos_bias slice. Q and dO come by TMA once per batch element; K, V and
// the bias tile through a ring of kStagesA stages behind full / empty
// mbarriers, refilled by thread 0. Lane layout as in K1. Writes rows[bh, r]
// = (gate log2 e, lse log2 e, D, 0) for r < round_up(t, 64) ((0, inf, 0, 0)
// past t: W = 0 there in pass B).
template <int kDim, bool kDrop>
__global__ void __launch_bounds__(kBwdThreads, kDim == 64 ? 3 : 1)
attention_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const __grid_constant__ CUtensorMap bias_map,
                             const float* __restrict__ gate, const float* __restrict__ lse,
                             float4* __restrict__ rows, uint32_t* __restrict__ keep_out,
                             __nv_bfloat16* __restrict__ dq, float* __restrict__ dgate,
                             float* __restrict__ dbias_part, int ldb, int batch, int num_heads,
                             int t, int d, float scale, Dropout dr) {
  using L = BwdALayout<kDim>;
  constexpr int kHalves = kDim / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + kStagesA;
  uint32_t* lane_bits = reinterpret_cast<uint32_t*>(base + L::kBits);
  auto stage = [&](int slot) { return base + L::kRing + slot * L::kStageBytes; };

  const int h = blockIdx.x, q0 = blockIdx.y * kBlockQ;
  const int b0 = blockIdx.z * batch / gridDim.z, b1 = (blockIdx.z + 1) * batch / gridDim.z;
  const int tiles = (t + kBlockK - 1) / kBlockK, tp = tiles * kBlockK;
  const int per_b = 2 * tiles;  // loads of a batch element: the D sweep, then the dS sweep
  const int loads = (b1 - b0) * per_b;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const bool producer = tid == 0;
  float* part = dbias_part + ((size_t)blockIdx.z * num_heads + h) * t * ldb;

  auto load = [&](int n) {  // the K, V and bias tiles of load n (thread 0)
    const int slot = n % kStagesA, j = n % tiles, bh = (b0 + n / per_b) * num_heads + h;
    unsigned char* st = stage(slot);
    mbar_expect_tx(&full[slot], L::kStageBytes, producer);
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) {
      tma_load_3d(st + hf * 64 * 128, &k_map, &full[slot], 64 * hf, j * kBlockK, bh, producer);
      tma_load_3d(st + L::kTileBytes + hf * 64 * 128, &v_map, &full[slot], 64 * hf, j * kBlockK,
                  bh, producer);
    }
    tma_load_3d(st + 2 * L::kTileBytes, &bias_map, &full[slot], j * kBlockK, q0, h, producer);
  };
  auto load_q = [&](int e) {  // Q and dO of batch element b0 + e (thread 0)
    const int bh = (b0 + e) * num_heads + h;
    mbar_expect_tx(q_bar, 2 * L::kTileBytes, producer);
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) {
      tma_load_3d(base + hf * 64 * 128, &q_map, q_bar, 64 * hf, q0, bh, producer);
      tma_load_3d(base + L::kTileBytes + hf * 64 * 128, &do_map, q_bar, 64 * hf, q0, bh, producer);
    }
  };
  if (producer) {
    mbar_init(q_bar, 1);
    for (int i = 0; i < kStagesA; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_q(0);
  for (int n = 0; n < kStagesA && n < loads; ++n) load(n);
  auto release = [&](int n) {  // as in K1
    const int slot = n % kStagesA;
    __syncwarp();
    mbar_arrive(&empty[slot], lane == 0);
    if (n + kStagesA < loads) {
      mbar_wait(&empty[slot], (n / kStagesA) & 1, producer);
      load(n + kStagesA);
    }
  };

  const int r_tile = 16 * warp + g;
  const int row[2] = {q0 + r_tile, q0 + r_tile + 8};
  const float c1 = scale * kLog2e;
  uint64_t qd[kHalves], dod[kHalves];
#pragma unroll
  for (int hf = 0; hf < kHalves; ++hf) {
    qd[hf] = sw128_desc(base + hf * 64 * 128);
    dod[hf] = sw128_desc(base + L::kTileBytes + hf * 64 * 128);
  }
  float s[32], dp[32], dqa[kHalves][32];
  uint32_t br[16], p[16];

  for (int e = 0; e < b1 - b0; ++e) {
    const int b = b0 + e, bh = b * num_heads + h;
    float gt[2], g2[2], l2[2], dl[2] = {0.f, 0.f}, dg[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool valid = row[i] < t;
      gt[i] = valid ? gate[(size_t)bh * t + row[i]] : 0.f;
      g2[i] = gt[i] * kLog2e;
      l2[i] = valid ? lse[(size_t)bh * t + row[i]] * kLog2e : 0.f;
    }
    uint32_t s1 = 0, s2 = 0;
    if (kDrop) dropout_streams(dr.seed, b, h, s1, s2);
    mbar_wait(q_bar, e & 1);

    // first sweep: D, the keep bits
    for (int j = 0; j < tiles; ++j) {
      const int n = e * per_b + j, slot = n % kStagesA, k0 = j * kBlockK;
      unsigned char* st = stage(slot);
      mbar_wait(&full[slot], (n / kStagesA) & 1);
      wgmma_fence();
      issue_rows_by_tile<kDim>(s, qd, st);
      issue_rows_by_tile<kDim>(dp, dod, st + L::kTileBytes);
      wgmma_commit();
      const uint32_t keep = kDrop ? keep_bits(s1, s2, row, k0, c, dr.threshold) : 0u;
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      bias_fragments<false>(br, st + 2 * L::kTileBytes, warp, lane);
      if (k0 + kBlockK <= t)
        tile_weights_bwd<false>(s, br, c1, g2, l2, k0 + 2 * c, t);
      else
        tile_weights_bwd<true>(s, br, c1, g2, l2, k0 + 2 * c, t);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int i = (x / 2) % 2;
        const float dpm = !kDrop ? dp[x] : (keep >> x) & 1u ? dp[x] * dr.keep_scale : 0.f;
        dl[i] = fmaf(s[x], dpm, dl[i]);
      }
      if (kDrop) {
        lane_bits[j * kBwdThreads + tid] = keep;
        uint32_t wd[2][2];
        packed_words(wd, keep, c);
        // lane c stores word c % 2 of row c / 2; keys and rows past t as 0
        const int i = c / 2, w = c % 2, n_keys = t - k0 - 32 * w;
        uint32_t word = c == 0 ? wd[0][0] : c == 1 ? wd[0][1] : c == 2 ? wd[1][0] : wd[1][1];
        word &= n_keys >= 32 ? 0xffffffffu : n_keys <= 0 ? 0u : (1u << n_keys) - 1u;
        keep_out[keep_word(bh, j, tiles, row[i]) + w] = row[i] < t ? word : 0u;
      }
      release(n);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // D of the rows: the 4 lanes of a row group hold its columns
      dl[i] += __shfl_xor_sync(0xffffffffu, dl[i], 1);
      dl[i] += __shfl_xor_sync(0xffffffffu, dl[i], 2);
      if (c == 0)
        rows[(size_t)bh * tp + row[i]] = row[i] < t ? make_float4(g2[i], l2[i], dl[i], 0.f)
                                                    : make_float4(0.f, INFINITY, 0.f, 0.f);
    }

    // second sweep: dS, dq, dgate, the partial d pos_bias
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
      for (int x = 0; x < 32; ++x) dqa[hf][x] = 0.f;
    for (int j = 0; j < tiles; ++j) {
      const int n = e * per_b + tiles + j, slot = n % kStagesA, k0 = j * kBlockK;
      unsigned char* st = stage(slot);
      mbar_wait(&full[slot], (n / kStagesA) & 1);
      wgmma_fence();
      issue_rows_by_tile<kDim>(s, qd, st);
      issue_rows_by_tile<kDim>(dp, dod, st + L::kTileBytes);
      wgmma_commit();
      const uint32_t keep = kDrop ? lane_bits[j * kBwdThreads + tid] : 0u;
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      bias_fragments<false>(br, st + 2 * L::kTileBytes, warp, lane);
      if (k0 + kBlockK <= t)
        tile_weights_bwd<false>(s, br, c1, g2, l2, k0 + 2 * c, t);
      else
        tile_weights_bwd<true>(s, br, c1, g2, l2, k0 + 2 * c, t);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int jj = x / 4, i = (x / 2) % 2, e2 = x % 2;
        const float dpm = !kDrop ? dp[x] : (keep >> x) & 1u ? dp[x] * dr.keep_scale : 0.f;
        const float ds = s[x] * (dpm - dl[i]);
        dg[i] = fmaf(ds, bias_value(br, jj, i, e2), dg[i]);
        s[x] = ds;
      }
      pack_a(p, s);
      // the pairs the chunk's earlier batch elements left (this lane wrote
      // them), requested while dS K runs
      float2 prev[8][2];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = k0 + 8 * jj + 2 * c;
          const bool ok = e > 0 && row[i] < t && col < t;  // no branch near the wgmma
          const float2 x =
              *reinterpret_cast<const float2*>(part + (ok ? (size_t)row[i] * ldb + col : 0));
          prev[jj][i] = ok ? x : make_float2(0.f, 0.f);
        }
      fence_regs(p);
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) fence_regs(dqa[hf]);
      wgmma_fence();
      issue_acc_by_tile<kDim>(dqa, p, st);  // dq += dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(p);
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) fence_regs(dqa[hf]);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = k0 + 8 * jj + 2 * c;
          if (row[i] < t && col < t)  // col + 1 < ldb; past t dS is 0
            *reinterpret_cast<float2*>(part + (size_t)row[i] * ldb + col) =
                make_float2(fmaf(gt[i], s[4 * jj + 2 * i], prev[jj][i].x),
                            fmaf(gt[i], s[4 * jj + 2 * i + 1], prev[jj][i].y));
        }
      release(n);
    }

    const size_t head = (size_t)bh * t * d;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the batch element is done: dgate and dq
      dg[i] += __shfl_xor_sync(0xffffffffu, dg[i], 1);
      dg[i] += __shfl_xor_sync(0xffffffffu, dg[i], 2);
      if (row[i] >= t) continue;
      if (c == 0) dgate[(size_t)bh * t + row[i]] = dg[i];
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = 64 * hf + 8 * jj + 2 * c;
          if (col < d)
            *reinterpret_cast<__nv_bfloat162*>(dq + head + (size_t)row[i] * d + col) =
                __floats2bfloat162_rn(dqa[hf][4 * jj + 2 * i] * scale,
                                      dqa[hf][4 * jj + 2 * i + 1] * scale);
        }
    }
    if (e + 1 < b1 - b0) {
      __syncthreads();  // no warp reads this element's Q and dO any more
      load_q(e + 1);
    }
  }
}

// Shared memory of a pass B block from a 1024-aligned base: K and V, staged
// once, then per ring stage Q, dO, the 64 x 64 bias tile, the 64 rows'
// (gate log2 e, lse log2 e, D, 0) and their packed keep words, then the
// barriers.
template <int kDim>
struct BwdBLayout {
  static constexpr uint32_t kTileBytes = 64 * kDim * 2;
  static constexpr uint32_t kBiasBytes = 64 * kBlockK * 2;
  static constexpr uint32_t kRowsBytes = 64 * 16;
  static constexpr uint32_t kBitsBytes = 64 * 8;
  static constexpr uint32_t kBias = 2 * kTileBytes;  // offsets within a stage
  static constexpr uint32_t kRows = kBias + kBiasBytes;
  static constexpr uint32_t kBitsAt = kRows + kRowsBytes;
  static constexpr uint32_t kStageBytes = (kBitsAt + kBitsBytes + 1023) / 1024 * 1024;
  static constexpr uint32_t kRing = 2 * kTileBytes;
  static constexpr uint32_t kBars = kRing + kStagesB * kStageBytes;
  static constexpr size_t kSmem = kBars + (1 + 2 * kStagesB) * sizeof(uint64_t) + 1024;
};

// K2 pass B, bf16: one block (a warpgroup) per (batch, head, 64 keys), K and
// V staged once, looping over the query tiles (FlashAttention-2 style
// without dq) whose Q, dO, bias tile, row values and packed keep words come
// through the ring. Per tile: s^T = K Q^T and dW'^T = V dO^T on wgmma, then
// dv += (W m)^T dO and dk += dS^T Q with W m and dS^T rounded to bf16 in
// registers and Q, dO MN-major. Lane (g, c) of warp w owns keys 16 w + g and
// + 8; the columns of its tiles are query rows, whose gate, lse and D come
// from pass A's rows, the bias transposed from the swizzled tile, and the
// keep bits from pass A's packed mask: no hash.
template <int kDim, bool kDrop>
__global__ void __launch_bounds__(kBwdThreads, kDim == 64 ? 2 : 1)
attention_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const __grid_constant__ CUtensorMap bias_map,
                               const float4* __restrict__ rows,
                               const uint32_t* __restrict__ keep_in,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                               int num_heads, int t, int d, float scale, Dropout dr) {
  using L = BwdBLayout<kDim>;
  constexpr int kHalves = kDim / 64;
  constexpr uint32_t kLoadBytes = L::kBitsAt + (kDrop ? L::kBitsBytes : 0);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + kStagesB;
  auto stage = [&](int slot) { return base + L::kRing + slot * L::kStageBytes; };

  const int bh = blockIdx.x, h = bh % num_heads, kb = blockIdx.y, k0 = kb * kBlockK;
  const int tiles = (t + kBlockQ - 1) / kBlockQ, tp = tiles * kBlockQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const bool producer = tid == 0;

  auto load = [&](int n) {  // query tile n (thread 0)
    const int slot = n % kStagesB, r0 = n * kBlockQ;
    unsigned char* st = stage(slot);
    mbar_expect_tx(&full[slot], kLoadBytes, producer);
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) {
      tma_load_3d(st + hf * 64 * 128, &q_map, &full[slot], 64 * hf, r0, bh, producer);
      tma_load_3d(st + L::kTileBytes + hf * 64 * 128, &do_map, &full[slot], 64 * hf, r0, bh,
                  producer);
    }
    tma_load_3d(st + L::kBias, &bias_map, &full[slot], k0, r0, h, producer);
    bulk_load(st + L::kRows, rows + (size_t)bh * tp + r0, L::kRowsBytes, &full[slot], producer);
    if (kDrop)
      bulk_load(st + L::kBitsAt, keep_in + keep_word(bh, kb, tiles, r0), L::kBitsBytes,
                &full[slot], producer);
  };
  if (producer) {
    mbar_init(kv_bar, 1);
    for (int i = 0; i < kStagesB; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  mbar_expect_tx(kv_bar, 2 * L::kTileBytes, producer);
#pragma unroll
  for (int hf = 0; hf < kHalves; ++hf) {
    tma_load_3d(base + hf * 64 * 128, &k_map, kv_bar, 64 * hf, k0, bh, producer);
    tma_load_3d(base + L::kTileBytes + hf * 64 * 128, &v_map, kv_bar, 64 * hf, k0, bh, producer);
  }
  for (int n = 0; n < kStagesB && n < tiles; ++n) load(n);
  auto release = [&](int n) {
    const int slot = n % kStagesB;
    __syncwarp();
    mbar_arrive(&empty[slot], lane == 0);
    if (n + kStagesB < tiles) {
      mbar_wait(&empty[slot], (n / kStagesB) & 1, producer);
      load(n + kStagesB);
    }
  };

  const float c1 = scale * kLog2e;
  // the lane's keys within the block: 16 warp + g + 8 i, bit 16 (warp % 2) + g + 8 i of word warp / 2
  const int bit0 = 16 * (warp % 2) + g, word = warp / 2;
  uint64_t kd[kHalves], vd[kHalves];
  float dka[kHalves][32], dva[kHalves][32];
#pragma unroll
  for (int hf = 0; hf < kHalves; ++hf) {
    kd[hf] = sw128_desc(base + hf * 64 * 128);
    vd[hf] = sw128_desc(base + L::kTileBytes + hf * 64 * 128);
#pragma unroll
    for (int x = 0; x < 32; ++x) dka[hf][x] = dva[hf][x] = 0.f;
  }
  float st_[32], dpt[32];
  uint32_t br[16], pw[16], pds[16];
  mbar_wait(kv_bar, 0);

  for (int n = 0; n < tiles; ++n) {
    const int slot = n % kStagesB;
    unsigned char* st = stage(slot);
    mbar_wait(&full[slot], (n / kStagesB) & 1);
    wgmma_fence();
    issue_rows_by_tile<kDim>(st_, kd, st);                    // K Q^T
    issue_rows_by_tile<kDim>(dpt, vd, st + L::kTileBytes);    // V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st_);
    fence_regs(dpt);
    bias_fragments<true>(br, st + L::kBias, warp, lane);
    const float4* rs = reinterpret_cast<const float4*>(st + L::kRows);
    const uint32_t* bits = reinterpret_cast<const uint32_t*>(st + L::kBitsAt);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * c + e;  // query row r0 + col
        const float4 rv = rs[col];  // (gate log2 e, lse log2 e, D): W = 0 past t
        const uint32_t kw = kDrop ? bits[2 * col + word] : 0u;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i + e;
          const float w = ex2(fmaf(st_[x], c1, rv.x * bias_value(br, j, i, e)) - rv.y);
          const bool kept = !kDrop || ((kw >> (bit0 + 8 * i)) & 1u);
          const float m = kDrop ? (kept ? dr.keep_scale : 0.f) : 1.f;
          st_[x] = w * m;                    // W m
          dpt[x] = w * (dpt[x] * m - rv.z);  // dS
        }
      }
    pack_a(pw, st_);
    pack_a(pds, dpt);
    fence_regs(pw);
    fence_regs(pds);
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) {
      fence_regs(dka[hf]);
      fence_regs(dva[hf]);
    }
    wgmma_fence();
    issue_acc_by_tile<kDim>(dva, pw, st + L::kTileBytes);  // (W m)^T dO
    issue_acc_by_tile<kDim>(dka, pds, st);                 // dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pw);
    fence_regs(pds);
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) {
      fence_regs(dka[hf]);
      fence_regs(dva[hf]);
    }
    release(n);
  }

  const size_t head = (size_t)bh * t * d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 16 * warp + g + 8 * i;
    if (key >= t) continue;
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * hf + 8 * j + 2 * c;
        if (col < d) {
          const size_t at = head + (size_t)key * d + col;
          *reinterpret_cast<__nv_bfloat162*>(dk + at) =
              __floats2bfloat162_rn(dka[hf][4 * j + 2 * i] * scale,
                                    dka[hf][4 * j + 2 * i + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + at) =
              __floats2bfloat162_rn(dva[hf][4 * j + 2 * i], dva[hf][4 * j + 2 * i + 1]);
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

// Pass A's float32 shared memory: the q, dO, K and V tiles and the dS tile.
static size_t pass_a_smem_f32(int d) {
  return sizeof(float) * ((size_t)(2 * kBlockQ + 2 * kBlockK) * (d + 1) +
                          (size_t)kBlockQ * (kBlockK + 1));
}

// K2's bf16 tensor maps: q, k, v and dO (d, t, b h) in boxes of 64 columns
// by 64 rows, the bias (t keys, t rows, h) in rows of ldbias, boxes of 64 x
// 64; rows and keys past t read as zeros.
struct BwdMaps {
  CUtensorMap q, k, v, dout, bias;
};

static int encode_bwd_maps(BwdMaps& m, const void* q, const void* k, const void* v,
                           const void* dout, const void* bias, int ldbias, int b, int h, int t,
                           int d) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const size_t mat = (size_t)t * d;
  int rc;
  if ((rc = encode_3d(encode, &m.q, q, d, t, b * h, d, mat, 64, kBlockQ)) != 0 ||
      (rc = encode_3d(encode, &m.k, k, d, t, b * h, d, mat, 64, kBlockK)) != 0 ||
      (rc = encode_3d(encode, &m.v, v, d, t, b * h, d, mat, 64, kBlockK)) != 0 ||
      (rc = encode_3d(encode, &m.dout, dout, d, t, b * h, d, mat, 64, kBlockQ)) != 0 ||
      (rc = encode_3d(encode, &m.bias, bias, t, t, h, ldbias, (size_t)t * ldbias, kBlockK,
                      kBlockQ)) != 0)
    return rc;
  return 0;
}

template <bool kDrop>
static int pass_a_blocks_per_sm(int d, int is_bf16, int t) {
  int blocks = 0;
  cudaError_t err;
  if (is_bf16) {
    auto pass_a = d <= 64 ? attention_bwd_dq_bf16_kernel<64, kDrop>
                          : attention_bwd_dq_bf16_kernel<128, kDrop>;
    const size_t smem = d <= 64 ? BwdALayout<64>::smem(t, kDrop) : BwdALayout<128>::smem(t, kDrop);
    if ((err = allow_smem(pass_a, smem)) != cudaSuccess) return -(int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pass_a, kBwdThreads, smem);
  } else {
    auto pass_a = d <= 64 ? attention_bwd_dq_f32_kernel<4, kDrop>
                          : attention_bwd_dq_f32_kernel<8, kDrop>;
    const size_t smem = pass_a_smem_f32(d);
    if ((err = allow_smem(pass_a, smem)) != cudaSuccess) return -(int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pass_a, kThreads, smem);
  }
  return err != cudaSuccess ? -(int)err : blocks;
}

// Blocks of pass A (the instance with dropout != 0 or without, at sequence
// length t: the bf16 instance with dropout keeps a word per lane and key
// tile in shared memory) that one SM of the current device holds at once
// (its registers and shared memory decide), or minus the CUDA error. The
// plan that splits the batch into chunks counts the card's resident blocks
// so.
extern "C" int gated_bias_attention_bwd_a_blocks_per_sm(int d, int is_bf16, int dropout, int t) {
  return dropout ? pass_a_blocks_per_sm<true>(d, is_bf16, t)
                 : pass_a_blocks_per_sm<false>(d, is_bf16, t);
}

template <int kDim, bool kDrop>
static int launch_pass_a_bf16(const BwdMaps& m, const float* gate, const float* lse, void* rows,
                              void* keep, void* dq, float* dgate, float* part, int b, int h,
                              int t, int d, int chunks, int ldb, Dropout dr, cudaStream_t s) {
  auto kernel = attention_bwd_dq_bf16_kernel<kDim, kDrop>;
  const size_t smem = BwdALayout<kDim>::smem(t, kDrop);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(h, (t + kBlockQ - 1) / kBlockQ, chunks);
  kernel<<<grid, kBwdThreads, smem, s>>>(
      m.q, m.k, m.v, m.dout, m.bias, gate, lse, static_cast<float4*>(rows),
      static_cast<uint32_t*>(keep), static_cast<__nv_bfloat16*>(dq), dgate, part, ldb, b, h, t, d,
      1.0f / sqrtf((float)d), dr);
  return (int)cudaGetLastError();
}

template <bool kDrop>
static int launch_pass_a_f32(const void* q, const void* k, const void* v, const void* bias,
                             int ldbias, const float* gate, const void* out, const void* dout,
                             const float* lse, float* delta, void* dq, float* dgate, float* part,
                             int b, int h, int t, int d, int chunks, int ldb, Dropout dr,
                             cudaStream_t s) {
  auto pass_a = d <= 64 ? attention_bwd_dq_f32_kernel<4, kDrop>
                        : attention_bwd_dq_f32_kernel<8, kDrop>;
  const size_t smem = pass_a_smem_f32(d);
  const cudaError_t err = allow_smem(pass_a, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(h, (t + kBlockQ - 1) / kBlockQ, chunks);
  pass_a<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), ldbias, gate, static_cast<const float*>(out),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), dgate, part, ldb, b,
      h, t, d, 1.0f / sqrtf((float)d), dr);
  return (int)cudaGetLastError();
}

// K2 pass A, for the backward of gated_bias_attention_fwd's training
// forward with the same dropout arguments (dropout == 0: the instance
// without the mask), one launch. Inputs: q, k, v and dout (out's
// cotangent), (b, h, t, d); bias (h, t, ldbias) with ldbias >= t a multiple
// of 8 and zeros past t; gate and lse (b, h, t) float32. Outputs: dq in q's
// type, dgate (b, h, t) float32, the chunks' partial dbias slices
// dbias_part (chunks, h, t, ldb) float32 with ldb >= t, ldb % 4 == 0 (rows
// 16-byte aligned), which gated_bias_attention_dbias_sum adds, and for pass
// B, in bf16: `rows` (b h, tp, 4) float32, tp = round_up(t, 64), (gate log2
// e, lse log2 e, D, 0) and (0, inf, 0, 0) past t, and with dropout `keep`,
// the packed keep mask (b h, tp / 64 key blocks, tp rows, 2) uint32 (bit k
// of word w of row r in key block kb: key 64 kb + 32 w + k; zero past t),
// which the instance without the mask leaves alone; in f32: `delta`, D (b,
// h, t), from `out`. The batch is split into `chunks` <= b chunks of
// consecutive elements, chunk z holding z b / chunks .. (z + 1) b / chunks
// - 1. Returns 0 or the error: a CUDA error, -1 when the driver has no
// cuTensorMapEncodeTiled, -1000 - the driver's error when a tensor map is
// refused.
extern "C" int gated_bias_attention_bwd_a_bf16(const void* q, const void* k, const void* v,
                                               const void* dout, const void* bias, int ldbias,
                                               const void* gate, const void* lse, void* rows,
                                               void* keep, void* dq, void* dgate,
                                               void* dbias_part, int b, int h, int t, int d,
                                               int chunks, int ldb, int dropout, uint32_t seed,
                                               uint32_t threshold, float keep_scale,
                                               void* stream) {
  BwdMaps maps;
  const int rc = encode_bwd_maps(maps, q, k, v, dout, bias, ldbias, b, h, t, d);
  if (rc != 0) return rc;
  auto launch = d <= 64 ? (dropout ? launch_pass_a_bf16<64, true> : launch_pass_a_bf16<64, false>)
                        : (dropout ? launch_pass_a_bf16<128, true>
                                   : launch_pass_a_bf16<128, false>);
  return launch(maps, static_cast<const float*>(gate), static_cast<const float*>(lse), rows, keep,
                dq, static_cast<float*>(dgate), static_cast<float*>(dbias_part), b, h, t, d,
                chunks, ldb, Dropout{seed, threshold, keep_scale},
                static_cast<cudaStream_t>(stream));
}

extern "C" int gated_bias_attention_bwd_a_f32(const void* q, const void* k, const void* v,
                                              const void* bias, int ldbias, const void* gate,
                                              const void* out, const void* dout, const void* lse,
                                              void* delta, void* dq, void* dgate,
                                              void* dbias_part, int b, int h, int t, int d,
                                              int chunks, int ldb, int dropout, uint32_t seed,
                                              uint32_t threshold, float keep_scale,
                                              void* stream) {
  auto launch = dropout ? launch_pass_a_f32<true> : launch_pass_a_f32<false>;
  return launch(q, k, v, bias, ldbias, static_cast<const float*>(gate), out, dout,
                static_cast<const float*>(lse), static_cast<float*>(delta), dq,
                static_cast<float*>(dgate), static_cast<float*>(dbias_part), b, h, t, d, chunks,
                ldb, Dropout{seed, threshold, keep_scale}, static_cast<cudaStream_t>(stream));
}

// dbias (h, t, t) float32 = the `chunks` partial slices of pass A (either
// type) added in chunk order, one launch of dbias_sum_kernel: the same bit
// for bit from call to call. Returns 0 or the CUDA error.
extern "C" int gated_bias_attention_dbias_sum(const void* dbias_part, void* dbias, int h, int t,
                                              int chunks, int ldb, void* stream) {
  const size_t n = (size_t)h * t * t;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  dbias_sum_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dbias_part), static_cast<float*>(dbias), chunks, h * t, t, ldb);
  return (int)cudaGetLastError();
}

template <int kDim, bool kDrop>
static int launch_pass_b_bf16(const BwdMaps& m, const void* rows, const void* keep, void* dk,
                              void* dv, int b, int h, int t, int d, Dropout dr, cudaStream_t s) {
  auto kernel = attention_bwd_dkdv_bf16_kernel<kDim, kDrop>;
  const size_t smem = BwdBLayout<kDim>::kSmem;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * h, (t + kBlockK - 1) / kBlockK);
  kernel<<<grid, kBwdThreads, smem, s>>>(
      m.q, m.k, m.v, m.dout, m.bias, static_cast<const float4*>(rows),
      static_cast<const uint32_t*>(keep), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), h, t, d, 1.0f / sqrtf((float)d), dr);
  return (int)cudaGetLastError();
}

template <bool kDrop>
static int launch_pass_b_f32(const void* q, const void* k, const void* v, const void* bias,
                             int ldbias, const float* gate, const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int b, int h, int t, int d,
                             Dropout dr, cudaStream_t s) {
  auto pass_b = d <= 64 ? attention_bwd_dkdv_f32_kernel<4, kDrop>
                        : attention_bwd_dkdv_f32_kernel<8, kDrop>;
  const size_t smem = sizeof(float) * ((size_t)(2 * kBlockQ + 2 * kBlockK) * (d + 1) +
                                       2 * (size_t)kBlockK * (kBlockQ + 1) + 3 * kBlockQ);
  const cudaError_t err = allow_smem(pass_b, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * h, (t + kBlockK - 1) / kBlockK);
  pass_b<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), ldbias, gate, static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), h, t, d, 1.0f / sqrtf((float)d), dr);
  return (int)cudaGetLastError();
}

// K2 pass B: dk, dv in q's type, one launch, from q, k, v, dout, bias
// (rows of ldbias) as pass A read them and what pass A wrote: bf16 `rows`
// and, with dropout, `keep` (no hash: only the keep scale); f32 `delta`,
// with gate and lse, replaying the mask from the same dropout arguments as
// pass A. Returns 0 or the error, as pass A.
extern "C" int gated_bias_attention_bwd_b_bf16(const void* q, const void* k, const void* v,
                                               const void* dout, const void* bias, int ldbias,
                                               const void* rows, const void* keep, void* dk,
                                               void* dv, int b, int h, int t, int d, int dropout,
                                               float keep_scale, void* stream) {
  BwdMaps maps;
  const int rc = encode_bwd_maps(maps, q, k, v, dout, bias, ldbias, b, h, t, d);
  if (rc != 0) return rc;
  auto launch = d <= 64 ? (dropout ? launch_pass_b_bf16<64, true> : launch_pass_b_bf16<64, false>)
                        : (dropout ? launch_pass_b_bf16<128, true>
                                   : launch_pass_b_bf16<128, false>);
  return launch(maps, rows, keep, dk, dv, b, h, t, d, Dropout{0u, 0u, keep_scale},
                static_cast<cudaStream_t>(stream));
}

extern "C" int gated_bias_attention_bwd_b_f32(const void* q, const void* k, const void* v,
                                              const void* bias, int ldbias, const void* gate,
                                              const void* dout, const void* lse,
                                              const void* delta, void* dk, void* dv, int b, int h,
                                              int t, int d, int dropout, uint32_t seed,
                                              uint32_t threshold, float keep_scale,
                                              void* stream) {
  auto launch = dropout ? launch_pass_b_f32<true> : launch_pass_b_f32<false>;
  return launch(q, k, v, bias, ldbias, static_cast<const float*>(gate), dout,
                static_cast<const float*>(lse), static_cast<const float*>(delta), dk, dv, b, h, t,
                d, Dropout{seed, threshold, keep_scale}, static_cast<cudaStream_t>(stream));
}
