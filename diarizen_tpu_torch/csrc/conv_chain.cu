// The WavLM feature extractor's layers 1-6 in one launch (K5): six times
// (conv1d, stride 2, no bias, 512 -> 512 channels, taps 3,3,3,3,2,2) followed
// by the exact-erf GELU, channels last:
//
//   y_s[t, :] = gelu( sum_j  y_{s-1}[2 t + j, :] . w_s[j] ),   y_0 = x
//
// with float32 accumulation and GELU, each stage's output rounded to the
// input type, and the first t_out frames of the sixth stage returned. The five
// intermediate activations never reach device memory.
//
// K5 replaces the Pallas TPU kernel diarizen_tpu/ops/conv_chain.py:_kernel
// (launched by fused_conv_chain). That kernel holds a (2080, 512) input tile
// in fast memory for 32 output frames and recomputes the halo of every tile.
// A Hopper block has 227 KB of shared memory and one output frame alone has a
// receptive field of 79 input frames, so the design is another one:
//
//  * One block owns one batch element and a span of consecutive output
//    frames, and walks along time. Every stage works in tiles of M frames.
//    Level s (the output of stage s, s = 1..5) lives in shared memory as
//    2 M + 1 frames: one frame carried over from the tile before and the two
//    newest tiles. A tile of stage s + 1 reads frames 2 j + tap of that
//    buffer, so it can run whenever stage s has finished two more tiles: the
//    stages run on a binary counter (stage 1 every step, stage 2 every second
//    step, ... stage 6 every 32nd), and nothing is recomputed after the start
//    of the span. The carried frame replaces the TPU kernel's halo.
//  * Each stage runs one frame behind its consumer's grid (tile q of stage s
//    starts at frame 2^(6-s) o0 - 1 + q M for a span that starts at output
//    frame o0), which makes "carry one frame, then two tiles" exact for both
//    tap counts. The first frame of the first tile of each stage is computed
//    from the zeroed carry and is never used for a frame that is stored.
//  * Ragged edges are masked here: input frames outside [0, t1) are staged as
//    zeros (nothing is read out of bounds, nothing is padded in memory),
//    tiles past the last frame a span needs are skipped, and only frames in
//    [o0, o1) are written.
//  * bfloat16 (M = 16): eight warps, each owning 64 of the 512 output
//    channels of the tile; the products run on the tensor cores with mma.sync
//    m16n8k16 (f32 accumulate), the A operand from shared memory through
//    ldmatrix (rows 2 j + tap), the B operand straight from device memory:
//    the wrapper packs the weights once into the order of the B fragments, so
//    a lane reads 16 contiguous bytes and a warp 512, and the next 32 input
//    channels' fragments are in flight while the current ones are used.
//  * float32 (M = 8): 256 threads on the CUDA cores, two output channels
//    and eight frames per thread, exact float32.
//
// Bound on an H100 at the serving shape (B 32, t1 25599, t_out 399, bf16):
// 1.25 TFLOP over 989 TFLOP/s is 1.26 ms, 860 MB over 3.35 TB/s is 0.26 ms:
// operations bound it. What limits THIS kernel is neither: every tile of M
// frames reads its stage's whole weight tensor (1.5 MB for three taps) from
// L2, M = 16 frames per weight read is 16 FLOP per L2 byte, and 806,000 tile
// frames x 1.4 MB / 16 is about 70 GB of L2 traffic per call. Shared memory
// fixes M: five levels of 2 M + 1 frames plus the input tile at 1 KB a frame
// fill 206 KB at M = 16. More frames per weight byte (two launches with
// fewer levels each, weights shared through a cluster, wgmma) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 512;        // channels of every layer
constexpr int kStages = 6;
constexpr int kThreads = 256;  // eight warps
// taps of stage s (index 0 unused), and where its weights start in the flat
// buffer, in units of kC * kC elements
__device__ __constant__ int kTaps[kStages + 1] = {0, 3, 3, 3, 3, 2, 2};
__device__ __constant__ int kWeightStart[kStages + 1] = {0, 0, 3, 6, 9, 12, 14};

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: nothing is read, 16 zero bytes are written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices: lane l gives the address of row l % 8 of matrix
// l / 8; with the addresses of load_a below the result is the A operand of
// m16n8k16.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <typename T>
struct Tile;

// bfloat16: M = 16 frames per tile; rows padded by 8 elements (16 bytes).
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kM = 16;
  static constexpr int kLd = kC + 8;
  // fragments of one (tap, 32 input channels): [warp 8][n-tile 8][lane 32] uint4
  static constexpr int kFragStride = 8 * 8 * 32;

  struct Acc {
    float v[8][4];  // n-tile j: rows g (v[j][0..1]) and g + 8 (v[j][2..3]), cols 8 j + 2 c, + 1
  };

  __device__ static __forceinline__ void load_b(uint4 (&b)[8], const uint4* w, int it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = __ldg(w + (size_t)it * kFragStride + j * 32);
  }

  __device__ static __forceinline__ void multiply(Acc& acc, const __nv_bfloat16* a_lane,
                                                  int it, const uint4 (&b)[8]) {
    const int tap = it >> 4, kp = it & 15;
    const __nv_bfloat16* a = a_lane + tap * kLd + kp * 32;
    uint32_t a0[4], a1[4];
    ldmatrix_x4(a0, a);
    ldmatrix_x4(a1, a + 16);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mma_bf16(acc.v[j], a0, b[j].x, b[j].y);
      mma_bf16(acc.v[j], a1, b[j].z, b[j].w);
    }
  }

  // acc = the tile's (16, 512) product over taps x 512 input channels: `src`
  // is the level buffer (frame j of the tile reads rows 2 j + tap), `w` the
  // stage's packed weights.
  __device__ static __forceinline__ void product(Acc& acc, const __nv_bfloat16* src,
                                                 const __nv_bfloat16* w, int taps) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc.v[j][0] = acc.v[j][1] = acc.v[j][2] = acc.v[j][3] = 0.f;
    const uint4* wl = reinterpret_cast<const uint4*>(w) + warp * (8 * 32) + lane;
    // this lane's ldmatrix row: matrix l / 8 covers rows (l / 8 % 2) * 8 .. + 8
    // and columns (l / 16) * 8 .. + 8 of the 16 x 16 A tile
    const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
    const __nv_bfloat16* a_lane = src + 2 * arow * kLd + acol;
    const int iters = taps * 16;  // even
    uint4 b0[8], b1[8];
    load_b(b0, wl, 0);
    for (int it = 0; it < iters; it += 2) {
      load_b(b1, wl, it + 1);
      multiply(acc, a_lane, it, b0);
      if (it + 2 < iters) load_b(b0, wl, it + 2);
      multiply(acc, a_lane, it + 1, b1);
    }
  }

  // GELU, round, and hand each pair of neighbouring channels of a frame to `put`
  template <typename Put>
  __device__ static __forceinline__ void finish(const Acc& acc, Put put) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * warp + 8 * j + c2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const __nv_bfloat162 y = __floats2bfloat162_rn(gelu_erf(acc.v[j][2 * half]),
                                                       gelu_erf(acc.v[j][2 * half + 1]));
        __nv_bfloat16* dst = put(g + 8 * half);
        if (dst != nullptr) *reinterpret_cast<__nv_bfloat162*>(dst + col) = y;
      }
    }
  }
};

// float32: M = 8 frames per tile, thread t owns channels t and t + 256.
template <>
struct Tile<float> {
  static constexpr int kM = 8;
  static constexpr int kLd = kC + 4;

  struct Acc {
    float v[kM][2];
  };

  // `w` is the stage's (taps, 512 in, 512 out) tensor
  __device__ static __forceinline__ void product(Acc& acc, const float* src, const float* w,
                                                 int taps) {
    const int t = threadIdx.x;
#pragma unroll
    for (int r = 0; r < kM; ++r) acc.v[r][0] = acc.v[r][1] = 0.f;
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
            acc.v[r][h] = fmaf(x.x, wv[0][h], acc.v[r][h]);
            acc.v[r][h] = fmaf(x.y, wv[1][h], acc.v[r][h]);
            acc.v[r][h] = fmaf(x.z, wv[2][h], acc.v[r][h]);
            acc.v[r][h] = fmaf(x.w, wv[3][h], acc.v[r][h]);
          }
        }
      }
    }
  }

  template <typename Put>
  __device__ static __forceinline__ void finish(const Acc& acc, Put put) {
    const int t = threadIdx.x;
#pragma unroll
    for (int r = 0; r < kM; ++r) {
      float* dst = put(r);
      if (dst != nullptr) {
        dst[t] = gelu_erf(acc.v[r][0]);
        dst[t + 256] = gelu_erf(acc.v[r][1]);
      }
    }
  }
};

// x: (batch, t1, 512); weights: the six stages back to back (bfloat16: packed
// B fragments, float32: (taps, in, out)); out: (batch, t_out, 512). Block
// (span index, batch element) computes output frames [o0, o1).
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_chain_kernel(const T* __restrict__ x, const T* __restrict__ weights, T* __restrict__ out,
                  int t1, int t_out, int span) {
  using Tl = Tile<T>;
  constexpr int M = Tl::kM, ld = Tl::kLd;
  constexpr int kRows = 2 * M + 1;          // frames per level buffer
  constexpr int kChunks = kC * sizeof(T) / 16;  // 16-byte pieces of an input frame
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* levels = reinterpret_cast<T*>(smem_raw);  // level s at levels + s * kRows * ld

  const int o0 = blockIdx.x * span;
  const int o1 = min(o0 + span, t_out);
  if (o0 >= o1) return;
  const int b = blockIdx.y;
  const T* xb = x + (size_t)b * t1 * kC;
  T* outb = out + (size_t)b * t_out * kC;
  const int tid = threadIdx.x;

  // last frame of each stage's output that the span needs
  int last[kStages + 1];
  last[kStages] = o1 - 1;
#pragma unroll
  for (int s = kStages - 1; s >= 1; --s) last[s] = 2 * last[s + 1] + kTaps[s + 1] - 1;

  for (int i = tid; i < kStages * kRows * ld; i += kThreads) levels[i] = T(0.f);
  __syncthreads();

  // tile q of stage 1 reads input frames 64 o0 - 2 + 2 q M .. + 2 M
  auto stage_input = [&](int q) {
    const int f0 = 64 * o0 - 2 + 2 * q * M;
    for (int i = tid; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * (16 / (int)sizeof(T));
      const int f = f0 + r;
      const bool valid = f >= 0 && f < t1;
      cp_async_16(levels + r * ld + c, xb + (size_t)(valid ? f : 0) * kC + c, valid);
    }
  };
  // first frame of tile q of stage s
  auto first_frame = [&](int s, int q) { return (o0 << (kStages - s)) - 1 + q * M; };

  const int tiles6 = (o1 - o0) / M + 1;  // tiles of stage 6 that hold frames o0 .. o1 - 1
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
      const T* src = levels + (size_t)(s - 1) * kRows * ld;
      if (f0 <= last[s]) {
        typename Tl::Acc acc;
        Tl::product(acc, src, weights + (size_t)kWeightStart[s] * kC * kC, kTaps[s]);
        if (s < kStages) {
          T* dst = levels + (size_t)s * kRows * ld + (size_t)(1 + (q & 1) * M) * ld;
          Tl::finish(acc, [&](int r) { return dst + r * ld; });
        } else {
          Tl::finish(acc, [&](int r) {
            const int f = f0 + r;
            return (f >= o0 && f < o1) ? outb + (size_t)f * kC : static_cast<T*>(nullptr);
          });
        }
      }
      __syncthreads();  // the tile is written; its source has been read
      if (s == 1) {
        if (first_frame(1, step + 1) <= last[1] && step + 1 < steps) stage_input(step + 1);
      } else {
        // the newest frame of level s - 1 becomes the frame carried into its next pair
        T* lvl = levels + (size_t)(s - 1) * kRows * ld;
        for (int i = tid; i < kC; i += kThreads) lvl[i] = lvl[2 * M * ld + i];
      }
    }
  }
  cp_async_wait_all();
}

template <typename T>
int launch(const void* x, const void* weights, void* out, int batch, int t1, int t_out,
           int span, cudaStream_t stream) {
  using Tl = Tile<T>;
  auto kernel = conv_chain_kernel<T>;
  const size_t smem = sizeof(T) * (size_t)kStages * (2 * Tl::kM + 1) * Tl::kLd;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_out + span - 1) / span, batch);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                           static_cast<const T*>(weights),
                                           static_cast<T*>(out), t1, t_out, span);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (batch, t1, 512) contiguous, 16-byte aligned, float32 (is_bf16 == 0) or
// bfloat16, t1 >= 64 (t_out - 1) + 79; weights: the six stages back to back,
// 16 x 512 x 512 elements of x's type (float32: each stage (taps, in, out);
// bfloat16: each stage packed as [tap][in / 32][out / 64][out / 8 % 8][lane 32]
// [8], the 8 values of lane 4 g + c being out channel 8 (out / 8) + g and in
// channels 32 (in / 32) + {2c, 2c+1, 2c+8, 2c+9, 2c+16, 2c+17, 2c+24, 2c+25});
// out: (batch, t_out, 512). One block per (span of `span` output frames,
// batch element); batch <= 65535. Returns the CUDA error of the launch.
extern "C" int conv_chain_fwd(const void* x, const void* weights, void* out, int batch, int t1,
                              int t_out, int span, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, weights, out, batch, t1, t_out, span, s);
  return launch<float>(x, weights, out, batch, t1, t_out, span, s);
}
