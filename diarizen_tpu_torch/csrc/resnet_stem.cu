// The ResNet34's stem (models/resnet.py): its one-channel 3x3 convolution
// with the folded BatchNorm's bias and the ReLU, from the fbank straight to
// channels-last activations. For an fbank x (B, T, F), read as the image
// x[b, 0, f, t], a weight w (C, 1, 3, 3) and a bias (C):
//
//   y[b, c, f, t] = relu(bias[c] + sum_{i,j} w[c, 0, i, j] x[b, 0, f + i - 1, t + j - 1])
//
// with zero padding of 1, float32 sums (no TF32 rounding) and the output in
// the input's type (float32 or bfloat16), laid out channels-last: element
// (b, c, f, t) at ((b F + f) T + t) C + c.
//
// Replaces no TPU kernel: the JAX package leaves the stem to XLA's
// convolution. Added because cuDNN has no NHWC engine for one input channel
// that runs without converting its input and filter first: on cuDNN's fused
// convolution the stem kept two nchwToNhwcKernel launches a call (0.086 of
// its 0.227 ms at 32 rows x 8 s on an H100), behind a transposed copy of the
// fbank, in a trunk that otherwise runs channels-last end to end.
//
// Bound on an H100 (32 rows x 798 frames x 80 bins, C 32, float32): bytes.
// The output is 261 MB against 8 MB read and 1.2 GFLOP: about 80 us at
// 3.35 TB/s. So the design spends nothing on the arithmetic and writes the
// output once, in full 128-byte lines:
//
//  * a block computes a tile of 4 mel bins x 32 frames x every channel of
//    one batch element; it stages the tile's input with its one-frame and
//    one-bin halo (6 x 34 values, read where the fbank lies, bins
//    contiguous: no transposed copy) and the weights and bias in shared
//    memory as float32;
//  * a thread computes 16 consecutive frames of one bin for one channel,
//    with its nine weights in registers and the 3 x 3 input window sliding
//    along time: three shared-memory reads a frame (the same address for
//    every thread of a position: a broadcast), nine FMAs, then the bias, the
//    ReLU and one rounding to the output type. Reading the window anew for
//    each output from shared memory left the kernel limited by its load
//    instructions, at 2.6x its bound;
//  * the threads of a group take a position's channels side by side, so
//    each frame's store is one contiguous run of C values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileT = 32;  // frames a block
constexpr int kTileF = 4;   // mel bins a block
constexpr int kRun = 16;    // frames a thread computes
constexpr int kRuns = kTileF * (kTileT / kRun);
constexpr int kHaloT = kTileT + 2;
constexpr int kHaloF = kTileF + 2;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    resnet_stem_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ bias, T* __restrict__ y, int n_t, int n_f,
                       int channels) {
  extern __shared__ float smem[];
  float* w_s = smem;                 // channels x 9
  float* b_s = w_s + channels * 9;   // channels
  float* x_s = b_s + channels;       // kHaloF rows (bins) x kHaloT columns (frames)
  const int t0 = blockIdx.x * kTileT, f0 = blockIdx.y * kTileF;
  const long long b = blockIdx.z;
  for (int i = threadIdx.x; i < channels * 9; i += kThreads) w_s[i] = to_float(w[i]);
  for (int i = threadIdx.x; i < channels; i += kThreads) b_s[i] = to_float(bias[i]);
  const T* xb = x + b * n_t * n_f;
  for (int i = threadIdx.x; i < kHaloF * kHaloT; i += kThreads) {
    const int tl = i / kHaloF, fl = i - tl * kHaloF;  // consecutive threads: consecutive bins
    const int t = t0 + tl - 1, f = f0 + fl - 1;
    x_s[fl * kHaloT + tl] = (t >= 0 && t < n_t && f >= 0 && f < n_f)
                                ? to_float(xb[(long long)t * n_f + f]) : 0.f;
  }
  __syncthreads();
  // a group's lanes hold one position's channels; a thread, kRun frames of one bin
  const int lanes = channels < kThreads ? channels : kThreads;  // threads a group
  const int groups = kThreads / lanes;
  const int g = threadIdx.x / lanes, c0 = threadIdx.x - g * lanes;
  if (g >= groups) return;
  for (int c = c0; c < channels; c += lanes) {
    float wr[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) wr[k] = w_s[c * 9 + k];
    const float bc = b_s[c];
    for (int run = g; run < kRuns; run += groups) {
      const int fl = run / (kTileT / kRun), tl0 = (run - fl * (kTileT / kRun)) * kRun;
      const int f = f0 + fl, t = t0 + tl0;
      if (f >= n_f || t >= n_t) continue;
      const float* xs = x_s + fl * kHaloT + tl0;  // bins f - 1 .. f + 1, frames t - 1 ..
      float a0[3], a1[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        a0[i] = xs[i * kHaloT];
        a1[i] = xs[i * kHaloT + 1];
      }
      T* out = y + ((b * n_f + f) * n_t + t) * channels + c;
      const int frames = n_t - t < kRun ? n_t - t : kRun;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        float a2[3], acc = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          a2[i] = xs[i * kHaloT + k + 2];
          acc = fmaf(wr[i * 3], a0[i], acc);
          acc = fmaf(wr[i * 3 + 1], a1[i], acc);
          acc = fmaf(wr[i * 3 + 2], a2[i], acc);
        }
        if (k < frames) store(out + (long long)k * channels, fmaxf(acc + bc, 0.f));
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          a0[i] = a1[i];
          a1[i] = a2[i];
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* y, int batch, int n_t, int n_f,
           int channels, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)channels * 10 + kHaloF * kHaloT);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resnet_stem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n_t + kTileT - 1) / kTileT, (n_f + kTileF - 1) / kTileF, batch);
  resnet_stem_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(y), n_t, n_f, channels);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int resnet_stem_f32(const void* x, const void* w, const void* bias, void* y,
                               int batch, int n_t, int n_f, int channels, void* stream) {
  return launch<float>(x, w, bias, y, batch, n_t, n_f, channels, stream);
}

extern "C" int resnet_stem_bf16(const void* x, const void* w, const void* bias, void* y,
                                int batch, int n_t, int n_f, int channels, void* stream) {
  return launch<__nv_bfloat16>(x, w, bias, y, batch, n_t, n_f, channels, stream);
}
