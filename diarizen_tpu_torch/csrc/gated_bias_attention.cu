// Attention forward with a fused, query-gated relative-position bias (K1).
//
//   o[b,h,i,:] = softmax_j(q[b,h,i,:] . k[b,h,j,:] / sqrt(D)
//                          + gate[b,h,i] * bias[h,i,j]) @ v[b,h,:,:]
//
// Replaces the Pallas TPU kernel diarizen_tpu/ops/flash_attention.py:_kernel
// (launched by flash_attention_gated_bias) on the inference path, with the
// same "deferred" softmax schedule: unnormalised p @ v accumulated in f32 and
// one divide by the f32 row sum at the end; p is rounded to the input type
// before the p @ v product, as the TPU kernel rounds it to v's type.
//
// Bound on an H100: for WavLM's T = 399, D = 64 the kernel reads q, k, v
// (B, H, T, D), the (H, T, T) bias and the (B, H, T) gate once and writes o:
// about 6.9 MB per head of a batch of 32 in bf16, against 4 * 32 * T^2 * D =
// 1.3 GFLOP of matrix products; at 3.35 TB/s and 989 TFLOP/s that is memory
// bound (about 2.1 us of traffic per head against 1.3 us of tensor-core work).
//
// Design: one block per (batch, head, 64-row query tile) walks the keys in
// 64-key tiles staged in shared memory, keeps an online-softmax running max
// and sum per row in registers, and never writes the (T, T) scores or the
// gated bias to device memory; the bias tile is read straight from device
// memory. Keys past T are masked in the kernel, so no input is padded.
//  * bfloat16 (the inference path): four warps, 16 query rows each; both
//    products on the tensor cores with mma.sync m16n8k16 (f32 accumulate).
//    The score accumulator's register layout is the A-operand layout of the
//    p @ v product, so p never leaves registers.
//  * float32: 256 threads on the CUDA cores in f32, exact for f32 inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;        // query rows per block
constexpr int kBlockK = 64;        // keys per shared-memory tile
constexpr float kMasked = -1e30f;  // score of a key past T

// ---------------------------------------------------------------------------
// bfloat16: tensor cores

constexpr int kWarps = 4;  // each warp owns 16 query rows

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

// Lane (g = lane / 4, c = lane % 4) of warp w owns query rows 16 w + g and
// 16 w + g + 8, and in each 8-wide column tile the columns 2 c and 2 c + 1.
template <int kDim>  // head dim padded to a multiple of 16
__global__ void __launch_bounds__(kWarps * 32)
gated_bias_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const __nv_bfloat16* __restrict__ bias,
                                 const float* __restrict__ gate,
                                 __nv_bfloat16* __restrict__ out,
                                 int num_heads, int t, int d, float scale) {
  constexpr int ld = kDim + 8;  // row stride: fragment loads hit 32 distinct banks
  constexpr int kSteps = kDim / 16;
  constexpr int kOut = kDim / 8;  // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockQ * ld;
  __nv_bfloat16* vs = ks + kBlockK * ld;

  const int bh = blockIdx.x;  // b * num_heads + h
  const int h = bh % num_heads;
  const int q0 = blockIdx.y * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);

  const size_t head = (size_t)bh * t * d;
  const __nv_bfloat16* bias_h = bias + (size_t)h * t * t;
  load_tile<kDim>(qs, q + head, q0, t, d);
  __syncthreads();

  const int rq = 16 * warp + g;  // this lane's first row within the tile
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const __nv_bfloat16* base = qs + rq * ld + 16 * s + c2;
    qf[s][0] = load_u32(base);
    qf[s][1] = load_u32(base + 8 * ld);
    qf[s][2] = load_u32(base + 8);
    qf[s][3] = load_u32(base + 8 * ld + 8);
  }
  const int row[2] = {q0 + rq, q0 + rq + 8};
  float gt[2], m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    gt[i] = row[i] < t ? gate[(size_t)bh * t + row[i]] : 0.f;
    m[i] = -INFINITY;
    l[i] = 0.f;  // this lane's share of the row sum; lanes are summed at the end
  }
  float o[kOut][4];
#pragma unroll
  for (int j = 0; j < kOut; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    __syncthreads();  // the previous tile's ks and vs are no longer read
    load_tile<kDim>(ks, k + head, k0, t, d);
    load_tile<kDim>(vs, v + head, k0, t, d);
    __syncthreads();

    // s = q k^T over 8 key tiles of 8: s[j][e], e < 2 on row 0, e >= 2 on row 1
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* base = ks + (8 * j + g) * ld + c2;
#pragma unroll
      for (int st = 0; st < kSteps; ++st)
        mma_bf16(s[j], qf[st], load_u32(base + 16 * st), load_u32(base + 16 * st + 8));
    }

    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const int col = k0 + 8 * j + c2 + (e & 1);
        float x = kMasked;
        if (col < t) {
          x = s[j][e] * scale;
          if (row[i] < t) x += gt[i] * __bfloat162float(bias_h[(size_t)row[i] * t + col]);
        }
        s[j][e] = x;
        tile_max[i] = fmaxf(tile_max[i], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the 4 lanes of a row group hold its 64 columns
      tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], 1));
      tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], 2));
      const float m_new = fmaxf(m[i], tile_max[i]);  // finite: key 0 is valid
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // p = exp(s - m): the f32 values feed the row sum, bf16 ones the product
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys per step of p @ v
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * kk + half;
        const float p0 = expf(s[j][0] - m[0]), p1 = expf(s[j][1] - m[0]);
        const float p2 = expf(s[j][2] - m[1]), p3 = expf(s[j][3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pa[2 * half] = pack_bf16(p0, p1);
        pa[2 * half + 1] = pack_bf16(p2, p3);
      }
      const int key = 16 * kk + (lane / 8 % 2) * 8 + lane % 8;
#pragma unroll
      for (int j = 0; j < kOut; j += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + key * ld + 8 * (j + lane / 16));
        mma_bf16(o[j], pa, vb[0], vb[1]);
        mma_bf16(o[j + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= t) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int col = 8 * j + c2;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(out + head + (size_t)row[i] * d + col) =
            __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
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

// Thread (ty, tx) owns query rows ty + 16 * i (i < kRows), keys tx + 16 * j of
// each tile (j < kKeys) and head-dim columns tx + 16 * j (j < kCols). The 16
// threads that share a row sit in one half-warp, so row reductions are
// shuffles. kCols * 16 >= D.
template <int kCols>
__global__ void __launch_bounds__(kThreads)
gated_bias_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ bias,
                                const float* __restrict__ gate, float* __restrict__ out,
                                int num_heads, int t, int d, float scale) {
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
  const float* bias_h = bias + (size_t)h * t * t;
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

  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    __syncthreads();  // the previous tile's ks, vs and ps are no longer read
    for (int i = tid; i < kBlockK * d; i += kThreads) {
      const int r = i / d, c = i % d;
      const int row = k0 + r;
      const bool valid = row < t;
      ks[r * ld + c] = valid ? kh[(size_t)row * d + c] : 0.f;
      vs[r * ld + c] = valid ? vh[(size_t)row * d + c] : 0.f;
    }
    __syncthreads();

    float s[kRows][kKeys];
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
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int col = k0 + tx + kThreadsX * j;
        if (col >= t) {
          s[i][j] = kMasked;
        } else if (row < t) {
          s[i][j] += g[i] * bias_h[(size_t)row * t + col];
        }
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = kThreadsX / 2; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      // key 0 is valid in the first tile, so m_new is finite from then on
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        ps[(ty + kThreadsY * i) * ldp + tx + kThreadsX * j] = p;
      }
#pragma unroll
      for (int off = kThreadsX / 2; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
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
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + kThreadsX * j;
      if (col < d) out[head + (size_t)row * d + col] = acc[i][j] * inv;
    }
  }
}

}  // namespace

// q, k, v, out: (b, h, t, d) contiguous, float32 (is_bf16 == 0) or bfloat16;
// bias: (h, t, t) in the same type; gate: (b, h, t) float32; d <= 128 and a
// multiple of 8; bfloat16 rows 16-byte aligned.
// Returns the CUDA error of the launch (0 on success).
extern "C" int gated_bias_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* bias, const void* gate, void* out,
                                        int b, int h, int t, int d, int is_bf16,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(b * h, (t + kBlockQ - 1) / kBlockQ);
  const float scale = 1.0f / sqrtf((float)d);
  cudaError_t err;
  if (is_bf16) {
    using bf16 = __nv_bfloat16;
    auto kernel = d <= 64 ? gated_bias_attention_bf16_kernel<64>
                          : gated_bias_attention_bf16_kernel<128>;
    const int dim = d <= 64 ? 64 : 128;
    const size_t smem = sizeof(bf16) * (size_t)(kBlockQ + 2 * kBlockK) * (dim + 8);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kWarps * 32, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(bias), static_cast<const float*>(gate), static_cast<bf16*>(out),
        h, t, d, scale);
  } else {
    auto kernel = d <= 64 ? gated_bias_attention_f32_kernel<4>
                          : gated_bias_attention_f32_kernel<8>;
    const size_t smem = sizeof(float) * ((size_t)(kBlockQ + 2 * kBlockK) * (d + 1) +
                                         (size_t)kBlockQ * (kBlockK + 1));
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(bias), static_cast<const float*>(gate), static_cast<float*>(out),
        h, t, d, scale);
  }
  return (int)cudaGetLastError();
}
