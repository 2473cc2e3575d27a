// Residual add + LayerNorm, and the same with the weighted-sum update: kernels
// K3 and K4.
//
// For a, b (rows, D) in bfloat16 or float32, gamma, beta (D,) in float32:
//
//   K3:  x = f32(a) + f32(b)                     (the sum is never rounded)
//        y = T((x - mean(x)) * rsqrt(mean((x - mean(x))^2) + eps) * gamma + beta)
//   K4:  the same y, and  acc += w * f32(y)      (acc float32 (rows, D), in
//        place; w one float32 read from device memory; the ROUNDED y is added)
//
// K3 replaces the Pallas TPU kernel diarizen_tpu/ops/fused_ln.py:
// _residual_ln_kernel, K4 _residual_ln_acc_kernel. The TPU kernels block rows
// to fill VMEM; nothing of that carries over.
//
// Bound on an H100: memory traffic alone. Per element K3 reads a and b and
// writes y (6 bytes in bfloat16), K4 also reads and writes acc (14 bytes),
// against about 10 float operations. At the serving shape (12768, 768) in
// bfloat16 that is 58.8 MB (0.0176 ms at 3.35 TB/s) and 137.3 MB (0.0410 ms).
//
// Design: one warp per row. A lane owns chunks of 8 consecutive elements
// (one 16-byte load in bfloat16, two in float32), chunk c of lane l at column
// (c * 32 + l) * 8, so a warp's loads are contiguous. The row's sum stays in
// registers (at most NCHUNK * 8 floats a lane, D <= 1024) across the two
// reductions (mean, then mean of squared deviations: not E[x^2] - mean^2),
// which are warp shuffles: no shared memory, no block-level sync, every byte
// of a, b and acc is read once and y and acc written once. gamma and beta go
// through the read-only cache. A ragged last block and any D that is a
// multiple of 8 are masked per chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kChunk = 8;  // elements a lane handles per chunk

__device__ __forceinline__ void load8(const float* p, float (&v)[kChunk]) {
    const float4 lo = *reinterpret_cast<const float4*>(p);
    const float4 hi = *reinterpret_cast<const float4*>(p + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kChunk]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ void load8_readonly(const float* p, float (&v)[kChunk]) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(p + 4));
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// Rounds v to T, stores it, and leaves the rounded values (as float) in v.
__device__ __forceinline__ void round_store8(float* p, float (&v)[kChunk]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void round_store8(__nv_bfloat16* p, float (&v)[kChunk]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
    *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, offset);
    }
    return v;
}

template <typename T, int NCHUNK, bool ACC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
residual_layer_norm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                           const float* __restrict__ gamma, const float* __restrict__ beta,
                           const float* __restrict__ w, float* __restrict__ acc,
                           T* __restrict__ y, int rows, int d, float eps) {
    const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (row >= rows) return;  // whole warps leave together
    const int lane = threadIdx.x & 31;
    const int64_t base = static_cast<int64_t>(row) * d;

    float x[NCHUNK][kChunk];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
        const int col = (c * 32 + lane) * kChunk;
        if (col < d) {
            float bv[kChunk];
            load8(a + base + col, x[c]);
            load8(b + base + col, bv);
#pragma unroll
            for (int i = 0; i < kChunk; ++i) {
                x[c][i] += bv[i];
                sum += x[c][i];
            }
        }
    }
    const float mean = warp_sum(sum) / static_cast<float>(d);

    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
        if ((c * 32 + lane) * kChunk < d) {
#pragma unroll
            for (int i = 0; i < kChunk; ++i) {
                x[c][i] -= mean;
                sq += x[c][i] * x[c][i];
            }
        }
    }
    const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(d) + eps);

    float weight = 0.f;
    if (ACC) weight = __ldg(w);
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
        const int col = (c * 32 + lane) * kChunk;
        if (col < d) {
            float g[kChunk], be[kChunk];
            load8_readonly(gamma + col, g);
            load8_readonly(beta + col, be);
#pragma unroll
            for (int i = 0; i < kChunk; ++i) {
                x[c][i] = x[c][i] * rstd * g[i] + be[i];
            }
            round_store8(y + base + col, x[c]);  // x now holds the rounded y
            if (ACC) {
                float s[kChunk];
                load8(acc + base + col, s);
#pragma unroll
                for (int i = 0; i < kChunk; ++i) {
                    // a multiply, then an add: what `acc + w * y` rounds to
                    s[i] = __fadd_rn(s[i], __fmul_rn(weight, x[c][i]));
                }
                round_store8(acc + base + col, s);
            }
        }
    }
}

template <typename T, bool ACC>
cudaError_t launch(const void* a, const void* b, const void* gamma, const void* beta,
                   const void* w, void* acc, void* y, int rows, int d, float eps,
                   cudaStream_t stream) {
    if (rows <= 0) return cudaSuccess;
    if (d <= 0 || d % kChunk != 0 || d > 4 * 32 * kChunk) return cudaErrorInvalidValue;
    const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
    const dim3 block(kWarpsPerBlock * 32);
    const int nchunk = (d + 32 * kChunk - 1) / (32 * kChunk);
#define RESIDUAL_LN_LAUNCH(N)                                                             \
    residual_layer_norm_kernel<T, N, ACC><<<grid, block, 0, stream>>>(                    \
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const float*>(gamma), \
        static_cast<const float*>(beta), static_cast<const float*>(w),                    \
        static_cast<float*>(acc), static_cast<T*>(y), rows, d, eps)
    switch (nchunk) {
        case 1: RESIDUAL_LN_LAUNCH(1); break;
        case 2: RESIDUAL_LN_LAUNCH(2); break;
        case 3: RESIDUAL_LN_LAUNCH(3); break;
        default: RESIDUAL_LN_LAUNCH(4); break;
    }
#undef RESIDUAL_LN_LAUNCH
    return cudaGetLastError();
}

}  // namespace

// K3. a, b, y: (rows, d) of bfloat16 (is_bf16 != 0) or float32, contiguous and
// 16-byte aligned; gamma, beta: (d,) float32; d a multiple of 8, at most 1024.
// Returns the CUDA error of the launch, 0 on success.
extern "C" int residual_layer_norm(const void* a, const void* b, const void* gamma,
                                   const void* beta, void* y, int rows, int d, float eps,
                                   int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        is_bf16 ? launch<__nv_bfloat16, false>(a, b, gamma, beta, nullptr, nullptr, y, rows, d, eps, s)
                : launch<float, false>(a, b, gamma, beta, nullptr, nullptr, y, rows, d, eps, s);
    return static_cast<int>(err);
}

// K4. As K3, plus w (one float32 in device memory) and acc ((rows, d) float32,
// updated in place).
extern "C" int residual_layer_norm_acc(const void* a, const void* b, const void* gamma,
                                       const void* beta, const void* w, void* acc, void* y,
                                       int rows, int d, float eps, int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        is_bf16 ? launch<__nv_bfloat16, true>(a, b, gamma, beta, w, acc, y, rows, d, eps, s)
                : launch<float, true>(a, b, gamma, beta, w, acc, y, rows, d, eps, s);
    return static_cast<int>(err);
}
