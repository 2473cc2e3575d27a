// The WavLM feature extractor's layers 1-6 (K5): six times (conv1d, stride 2,
// no bias, 512 -> 512 channels, taps 3,3,3,3,2,2) followed by the exact-erf
// GELU, channels last:
//
//   y_s[t, :] = gelu( sum_j  y_{s-1}[2 t + j, :] . w_s[j] ),   y_0 = x
//
// with float32 accumulation and GELU, each stage's output rounded to the
// input type, and the first t_out frames of the sixth stage returned.
//
// K5 replaces the Pallas TPU kernel diarizen_tpu/ops/conv_chain.py:_kernel
// (launched by fused_conv_chain). That kernel keeps the five intermediate
// activations out of device memory: it holds a (2080, 512) input tile in the
// TPU's large fast memory and runs the six stages on it. On the H100 that
// fusion costs more than it saves. The intermediates of a batch of 32 windows
// (B 32, t1 25599, t_out 399) total 811 MB: written and read once they cost
// about 0.5 ms of HBM time. Keeping them in a 227 KB shared memory forced the
// first design of this kernel (one launch, a block walking along time with
// five level buffers of 33 frames) to 16-frame tiles, each of which read its
// stage's whole weight tensor (1.5 MB) from L2: about 70 GB of L2 reads a
// call and 10.0-11.0 ms, twice the time of six cuDNN convolutions.
//
// Bound on an H100 at that shape (bf16): 1.25 TFLOP over 989 TFLOP/s is
// 1.26 ms; bytes are 0.26 ms fused (input, weights, output) and 0.74 ms with
// the intermediates written and read. Operations bound it either way, so the
// design spends the bytes and buys tensor-core time:
//
//  * bfloat16: each stage is one implicit GEMM on the tensor cores, one
//    launch per stage (six CUDA launches a call), the intermediates in a
//    scratch buffer that the wrapper allocates. In channels-last layout row
//    t of a stage's A operand is input frames 2 t .. 2 t + k - 1, which lie
//    contiguously in memory: no im2col copy is made. Stage s is (B T_s) x
//    (k 512) by (k 512) x 512 against the stage's weights packed once as a
//    (512 out, k 512 in) K-major matrix.
//  * A block computes 128 frames of one batch element by 256 output channels
//    (grid: 2 channel halves x frame tiles x batch). Three warpgroups: one
//    producer thread issues TMA loads into a ring of four 48 KB stages behind
//    full / empty mbarriers; two consumer warpgroups each run wgmma
//    m64n256k16 from shared memory (128B swizzle, f32 accumulators in 128
//    registers a thread, one group kept in flight) and then apply the GELU,
//    round to bf16 and store their 64 x 256 tile. setmaxnreg moves registers
//    from the producer to the consumers.
//  * The A tile of one K step is one tap (64 channels) of 128 output frames:
//    a TMA box of a (512, T_in, B) tensor map whose frame dimension is walked
//    with a traversal stride of 2, starting at frame 2 t0 + tap. Frames at or
//    past T_in are filled with zeros by the TMA unit, a tile never leaves its
//    batch element, and frames past a stage's last needed frame are computed
//    but not stored: nothing is padded or copied in memory.
//  * Weight traffic falls from 1.5 MB per 16 frames to 0.8 MB per 128
//    frames and 256 channels; what bounds this design is L2 (about 85 FLOP per
//    byte loaded per block) and the tensor cores. A two-block cluster that
//    multicasts the B tile was tried and ran slower on an H100.
//  * float32 (the card's exact-parity route, not a served one) keeps the
//    first design on the CUDA cores: one launch, 256 threads, two output
//    channels and eight frames per thread, the five levels in shared memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 512;  // channels of every layer

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// bfloat16: one stage as an implicit GEMM (TMA, mbarriers, wgmma)

constexpr int kBM = 128;  // frames per block: two consumer warpgroups of 64
constexpr int kBN = 256;  // output channels per block
constexpr int kBK = 64;   // channels per K step: one 128-byte swizzle row
constexpr int kPipe = 4;  // stages of the shared-memory ring
constexpr int kGemmThreads = 384;
constexpr uint32_t kABytes = kBM * kBK * 2;
constexpr uint32_t kStageBytes = (kBM + kBN) * kBK * 2;  // 48 KB
constexpr size_t kGemmSmem = kPipe * kStageBytes + 2 * kPipe * sizeof(uint64_t) + 1024;

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` to complete. A phase that never
// completes (a TMA transaction lost) traps after about 2^35 cycles instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - start > (1ll << 35)) __trap();
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma descriptor of a K-major tile in the 128B-swizzled layout TMA writes:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), base 1024-aligned.
// One k16 step further along K is 32 bytes: +2 in the address field.
__device__ __forceinline__ uint64_t sw128_desc(const void* smem) {
  const uint32_t addr = smem_u32(smem);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (64 x 256 f32 of the warpgroup) += A (64 x 16) . B (16 x 256), both from
// shared memory. Thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4
// (d[4 j], d[4 j + 1]) and that + 8 (d[4 j + 2], d[4 j + 3]), columns
// 8 j + 2 (t % 4) and + 1.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// x: (batch, t_in, 512) through a_map; weights (512, taps 512) through b_map;
// y: (batch, t_stage, 512). Block (channel half, frame tile, batch element).
__global__ void __launch_bounds__(kGemmThreads, 1)
conv_stage_kernel(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map, __nv_bfloat16* __restrict__ y,
                  int t_stage, int taps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kPipe * kStageBytes);
  uint64_t* empty = full + kPipe;
  const int wg = threadIdx.x / 128;
  const int n0 = blockIdx.x * kBN, t0 = blockIdx.y * kBM, b = blockIdx.z;
  const int steps = taps * (kC / kBK);  // K steps: tap s / 8, channels 64 (s % 8)

  if (threadIdx.x == 0) {
    for (int i = 0; i < kPipe; ++i) {
      mbar_init(&full[i], 1);   // the producer's expect_tx; TMA completes the bytes
      mbar_init(&empty[i], 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      for (int s = 0; s < steps; ++s) {
        const int slot = s % kPipe;
        mbar_wait(&empty[slot], ((s / kPipe) & 1) ^ 1);  // first round passes at once
        unsigned char* sa = base + slot * kStageBytes;
        mbar_expect_tx(&full[slot], kStageBytes);
        tma_load_3d(sa, &a_map, &full[slot], (s % 8) * kBK, 2 * t0 + s / 8, b);
        tma_load_2d(sa + kABytes, &b_map, &full[slot], s * kBK, n0);
      }
    }
  } else {  // consumer warpgroups 0 and 1: frames t0 + 64 wg .. + 64
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    for (int s = 0; s < steps; ++s) {
      const int slot = s % kPipe;
      mbar_wait(&full[slot], (s / kPipe) & 1);
      const unsigned char* sa = base + slot * kStageBytes;
      const uint64_t da = sw128_desc(sa + wg * 64 * kBK * 2);
      const uint64_t db = sw128_desc(sa + kABytes);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k) wgmma_m64n256k16(d, da + 2 * k, db + 2 * k, 1u);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous step's products are done: its slot goes back to the producer
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (s > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(s - 1) % kPipe]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int r0 = t0 + wg * 64 + warp * 16 + lane / 4;
    __nv_bfloat16* yb = y + (size_t)blockIdx.z * t_stage * kC + n0 + 2 * (lane % 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = r0 + 8 * half;
      if (t < t_stage) {
        __nv_bfloat16* row = yb + (size_t)t * kC;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
              gelu_erf(d[4 * j + 2 * half]), gelu_erf(d[4 * j + 2 * half + 1]));
        }
      }
    }
  }
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

// ---------------------------------------------------------------------------
// float32: the six stages in one launch, on the CUDA cores

constexpr int kStages = 6;
constexpr int kThreads = 256;
constexpr int kM = 8;          // frames per tile
constexpr int kLd = kC + 4;    // padded row of a level buffer
constexpr int kRows = 2 * kM + 1;  // frames per level buffer: one carried, two tiles
// taps of stage s (index 0 unused), and where its weights start in the flat
// buffer, in units of kC * kC elements
__device__ __constant__ int kTaps[kStages + 1] = {0, 3, 3, 3, 3, 2, 2};
__device__ __constant__ int kWeightStart[kStages + 1] = {0, 0, 3, 6, 9, 12, 14};

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const int bytes = valid ? 16 : 0;  // 0: nothing is read, 16 zero bytes are written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// acc[r][h] = the tile's frame r, channel threadIdx.x + 256 h: `src` is the
// level buffer (frame r of the tile reads rows 2 r + tap), `w` the stage's
// (taps, 512 in, 512 out) weights.
__device__ __forceinline__ void product_f32(float (&acc)[kM][2], const float* src,
                                            const float* w, int taps) {
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kM; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int tap = 0; tap < taps; ++tap) {
    const float* wt = w + (size_t)tap * kC * kC + t;
    const float* a = src + tap * kLd;
#pragma unroll 2
    for (int c = 0; c < kC; c += 4) {
      float wv[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wv[i][0] = __ldg(wt + (size_t)(c + i) * kC);
        wv[i][1] = __ldg(wt + (size_t)(c + i) * kC + 256);
      }
#pragma unroll
      for (int r = 0; r < kM; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(a + 2 * r * kLd + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[r][h] = fmaf(x.x, wv[0][h], acc[r][h]);
          acc[r][h] = fmaf(x.y, wv[1][h], acc[r][h]);
          acc[r][h] = fmaf(x.z, wv[2][h], acc[r][h]);
          acc[r][h] = fmaf(x.w, wv[3][h], acc[r][h]);
        }
      }
    }
  }
}

// One block owns one batch element and a span of output frames [o0, o1) and
// walks along time. Level s (the output of stage s, s = 1..5) lives in shared
// memory as 2 M + 1 frames: one frame carried over from the tile before and
// the two newest tiles. A tile of stage s + 1 reads frames 2 j + tap of that
// buffer, so it runs whenever stage s has finished two more tiles: the stages
// run on a binary counter. Each stage runs one frame behind its consumer's
// grid (tile q of stage s starts at frame 2^(6-s) o0 - 1 + q M), which makes
// "carry one frame, then two tiles" exact for both tap counts. Input frames
// outside [0, t1) are staged as zeros; only frames in [o0, o1) are written.
__global__ void __launch_bounds__(kThreads)
conv_chain_f32_kernel(const float* __restrict__ x, const float* __restrict__ weights,
                      float* __restrict__ out, int t1, int t_out, int span) {
  constexpr int kChunks = kC * sizeof(float) / 16;  // 16-byte pieces of an input frame
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* levels = reinterpret_cast<float*>(smem_raw);  // level s at levels + s * kRows * kLd

  const int o0 = blockIdx.x * span;
  const int o1 = min(o0 + span, t_out);
  if (o0 >= o1) return;
  const float* xb = x + (size_t)blockIdx.y * t1 * kC;
  float* outb = out + (size_t)blockIdx.y * t_out * kC;
  const int tid = threadIdx.x;

  // last frame of each stage's output that the span needs
  int last[kStages + 1];
  last[kStages] = o1 - 1;
#pragma unroll
  for (int s = kStages - 1; s >= 1; --s) last[s] = 2 * last[s + 1] + kTaps[s + 1] - 1;

  for (int i = tid; i < kStages * kRows * kLd; i += kThreads) levels[i] = 0.f;
  __syncthreads();

  // tile q of stage 1 reads input frames 64 o0 - 2 + 2 q M .. + 2 M
  auto stage_input = [&](int q) {
    const int f0 = 64 * o0 - 2 + 2 * q * kM;
    for (int i = tid; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      const int f = f0 + r;
      const bool valid = f >= 0 && f < t1;
      cp_async_16(levels + r * kLd + c, xb + (size_t)(valid ? f : 0) * kC + c, valid);
    }
  };
  auto first_frame = [&](int s, int q) { return (o0 << (kStages - s)) - 1 + q * kM; };

  const int tiles6 = (o1 - o0) / kM + 1;  // tiles of stage 6 that hold frames o0 .. o1 - 1
  const int steps = tiles6 << (kStages - 1);
  stage_input(0);
  for (int step = 0; step < steps; ++step) {
    cp_async_wait_all();
    __syncthreads();
    int q = step;
    for (int s = 1; s <= kStages; ++s) {
      if (s > 1) {
        if ((q & 1) == 0) break;  // stage s runs after every second tile of stage s - 1
        q >>= 1;
      }
      const int f0 = first_frame(s, q);
      const float* src = levels + (size_t)(s - 1) * kRows * kLd;
      if (f0 <= last[s]) {
        float acc[kM][2];
        product_f32(acc, src, weights + (size_t)kWeightStart[s] * kC * kC, kTaps[s]);
#pragma unroll
        for (int r = 0; r < kM; ++r) {
          float* dst;
          if (s < kStages) {
            dst = levels + (size_t)s * kRows * kLd + (size_t)(1 + (q & 1) * kM + r) * kLd;
          } else {
            const int f = f0 + r;
            dst = (f >= o0 && f < o1) ? outb + (size_t)f * kC : nullptr;
          }
          if (dst != nullptr) {
            dst[tid] = gelu_erf(acc[r][0]);
            dst[tid + 256] = gelu_erf(acc[r][1]);
          }
        }
      }
      __syncthreads();  // the tile is written; its source has been read
      if (s == 1) {
        if (first_frame(1, step + 1) <= last[1] && step + 1 < steps) stage_input(step + 1);
      } else {
        // the newest frame of level s - 1 becomes the frame carried into its next pair
        float* lvl = levels + (size_t)(s - 1) * kRows * kLd;
        for (int i = tid; i < kC; i += kThreads) lvl[i] = lvl[2 * kM * kLd + i];
      }
    }
  }
  cp_async_wait_all();
}

}  // namespace

// One stage of the bfloat16 chain: x (batch, t_in, 512) contiguous and
// 16-byte aligned; w (512 out, taps * 512 in) with column tap * 512 + in;
// y (batch, t_stage, 512) with 2 (t_stage - 1) + taps <= t_in. Frames at or
// past t_in read as zeros. Returns 0, the CUDA error of the launch, -1 when
// the driver has no cuTensorMapEncodeTiled, or -1000 - the driver's error
// when a tensor map is refused.
extern "C" int conv_chain_stage_bf16(const void* x, const void* w, void* y, int batch, int t_in,
                                     int t_stage, int taps, void* stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  CUtensorMap a_map, b_map;
  {  // A: (512, t_in, batch), boxes of 64 channels x 128 frames taken every second frame
    const cuuint64_t dims[3] = {(cuuint64_t)kC, (cuuint64_t)t_in, (cuuint64_t)batch};
    const cuuint64_t strides[2] = {(cuuint64_t)kC * 2, (cuuint64_t)t_in * kC * 2};
    const cuuint32_t box[3] = {(cuuint32_t)kBK, (cuuint32_t)(2 * kBM), 1};
    const cuuint32_t step[3] = {1, 2, 1};
    CUresult r = encode(&a_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -1000 - (int)r;
  }
  {  // B: (taps * 512, 512 out), boxes of 64 K x 256 output channels
    const cuuint64_t dims[2] = {(cuuint64_t)taps * kC, (cuuint64_t)kC};
    const cuuint64_t strides[1] = {(cuuint64_t)taps * kC * 2};
    const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)kBN};
    const cuuint32_t step[2] = {1, 1};
    CUresult r = encode(&b_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -1000 - (int)r;
  }
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(conv_stage_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kGemmSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(kC / kBN, (t_stage + kBM - 1) / kBM, batch);
  conv_stage_kernel<<<grid, kGemmThreads, kGemmSmem, static_cast<cudaStream_t>(stream)>>>(
      a_map, b_map, static_cast<__nv_bfloat16*>(y), t_stage, taps);
  return (int)cudaGetLastError();
}

// The float32 chain in one launch: x (batch, t1, 512) contiguous, 16-byte
// aligned, t1 >= 64 (t_out - 1) + 79; weights: the six stages back to back,
// each (taps, 512 in, 512 out); out: (batch, t_out, 512). One block per (span
// of `span` output frames, batch element); batch <= 65535. Returns the CUDA
// error of the launch.
extern "C" int conv_chain_f32(const void* x, const void* weights, void* out, int batch, int t1,
                              int t_out, int span, void* stream) {
  const size_t smem = sizeof(float) * (size_t)kStages * kRows * kLd;
  cudaError_t err = cudaFuncSetAttribute(conv_chain_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_out + span - 1) / span, batch);
  conv_chain_f32_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(weights), static_cast<float*>(out),
      t1, t_out, span);
  return (int)cudaGetLastError();
}
