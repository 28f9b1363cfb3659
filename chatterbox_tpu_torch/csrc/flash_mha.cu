// K2: bidirectional multi-head attention with a key-validity mask, for Hopper
// (sm_90a).
//
// Replaces chatterbox_tpu/ops/pallas_mha.py::flash_mha (kernel _mha_kernel),
// which carries every transformer block of every CFM estimator evaluation on
// the uncached S3Gen path. It computes what that kernel computes: softmax over
// the valid keys of q·kᵀ·scale with float32 accumulation, a row whose keys are
// all masked returning 0. Unlike the Pallas kernel it pads nothing outside:
// the ragged T edge is masked inside the kernel.
//
// What bounds it on the H100: at the serving shapes (T ≈ 600-2,500 frames,
// dh = 64) it is compute-bound — 4·T²·dh flops against 4·T·dh elements read per
// (lane, head). The design keeps every intermediate (scores, probabilities,
// running max/sum, the output accumulator) on chip: one block per
// (q-tile of 64 rows, head, lane) loops over 64-key tiles with an online
// softmax, so device memory sees only q, k, v, the mask and the output. This
// first version multiplies on the CUDA cores in float32 (inputs of either
// dtype are widened in shared memory); tensor-core products (mma/wgmma on
// bf16 or tf32 tiles) are the next step for speed.
//
// Layouts: q/k/v/out [B, H, T, dh] contiguous; valid [B, T] bool (one byte).
// Launches on the caller's stream, allocates nothing, does not synchronise;
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // 16 x 16: each thread owns 4 rows x 4 keys of S
constexpr float kNegInf = -1e9f;   // finite mask value, as the JAX package

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }

// max/sum across the 16 lanes (tx) that share a row group
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// shared memory (floats): q [kBQ][DH+1] | k [kBK][DH+1] | v [kBK][DH] | p [kBQ][kBK+1]
template <int DH>
__host__ __device__ constexpr size_t smem_floats() {
  return size_t(kBQ * (DH + 1) + kBK * (DH + 1) + kBK * DH + kBQ * (kBK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_mha_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ valid, T* __restrict__ out, int H, int Tn,
                 float scale) {
  static_assert(DH % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kDC = DH / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                         // [kBQ][DH+1], pre-scaled
  float* k_s = q_s + kBQ * (DH + 1);         // [kBK][DH+1]
  float* v_s = k_s + kBK * (DH + 1);         // [kBK][DH]
  float* p_s = v_s + kBK * DH;               // [kBQ][kBK+1]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // key / output-column group
  const int ty = tid >> 4;   // row group: rows ty*4 .. ty*4+3
  const size_t base = (size_t(b) * H + h) * size_t(Tn) * DH;
  const uint8_t* vrow = valid + size_t(b) * Tn;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i - r * DH;
    const int t = q0 + r;
    q_s[r * (DH + 1) + d] = t < Tn ? to_f32(q[base + size_t(t) * DH + d]) * scale : 0.f;
  }

  float m_i[4], l_i[4], o[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Tn; k0 += kBK) {
    __syncthreads();  // previous tile's k/v/p fully consumed (and q staged)
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int r = i / DH, d = i - r * DH;
      const int t = k0 + r;
      const bool in = t < Tn;
      k_s[r * (DH + 1) + d] = in ? to_f32(k[base + size_t(t) * DH + d]) : 0.f;
      v_s[i] = in ? to_f32(v[base + size_t(t) * DH + d]) : 0.f;
    }
    __syncthreads();

    // S micro-tile: rows ty*4+i, keys tx + 16*j
    float s[4][4];
    bool kval[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = k0 + tx + 16 * j;
      kval[j] = t < Tn && vrow[t] != 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax per row; the 16 tx lanes of a row group hold its 64 keys
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) mx = fmaxf(mx, kval[j] ? s[i][j] : kNegInf);
      mx = row_max(mx);
      const float m_new = fmaxf(m_i[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = kval[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        p_s[(ty * 4 + i) * (kBK + 1) + tx + 16 * j] = p;
      }
      sum = row_sum(sum);
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

    // O micro-tile += P @ V: rows ty*4+i, columns tx + 16*c
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[kDC];
#pragma unroll
      for (int c = 0; c < kDC; ++c) vv[c] = v_s[j * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty * 4 + i) * (kBK + 1) + j];
#pragma unroll
        for (int c = 0; c < kDC; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= Tn) continue;
    const float inv = 1.f / fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDC; ++c) from_f32(o[i][c] * inv, out + base + size_t(t) * DH + tx + 16 * c);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out,
           int B, int H, int Tn, float scale, cudaStream_t stream) {
  auto kernel = flash_mha_kernel<T, DH>;
  const size_t bytes = smem_floats<DH>() * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Tn + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), static_cast<T*>(out), H, Tn, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch_dh(int Dh, const void* q, const void* k, const void* v, const void* valid,
                void* out, int B, int H, int Tn, float scale, cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch<T, 32>(q, k, v, valid, out, B, H, Tn, scale, stream);
    case 64: return launch<T, 64>(q, k, v, valid, out, B, H, Tn, scale, stream);
    case 128: return launch<T, 128>(q, k, v, valid, out, B, H, Tn, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16
extern "C" int flash_mha_launch(const void* q, const void* k, const void* v,
                                const void* valid, void* out, int B, int H, int Tn,
                                int Dh, int dtype, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Tn <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dh<float>(Dh, q, k, v, valid, out, B, H, Tn, scale, s);
  if (dtype == 1) return dispatch_dh<__nv_bfloat16>(Dh, q, k, v, valid, out, B, H, Tn, scale, s);
  return cudaErrorInvalidValue;
}
