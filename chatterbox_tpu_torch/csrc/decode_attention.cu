// K1: single-query decode attention over the T3 KV cache, for Hopper (sm_90a).
//
// Replaces chatterbox_tpu/ops/pallas_attention_v3.py::paired_decode_attention
// (bodies _kernel for a bf16/f32 cache and _kernel_int8 for an int8 cache with
// per-token f32 scales). It computes what that kernel computes, not its block
// structure: for lane b and query head h (kv head hk = h / G), softmax over the
// cached keys in [start[b], pos[b]) plus the current token's unquantised k/v as
// a self-term, folded in before normalising. int8 scales multiply the scores
// and the probabilities; no dequantised cache is written.
//
// What bounds it on the H100: bytes. Each step reads the filled cache prefix
// (2 * S * Dh elements per (lane, kv head)) and does ~4 flops per element, far
// below the card's ~295 flop/byte balance point, so the kernel is a memory
// stream. The design reads only each row's own [start, pos) prefix (the TPU
// kernel read a static view bucket), in 64-key tiles staged through shared
// memory as float32, with the online-softmax state (max, sum, accumulator) in
// shared memory. One block per (lane, kv head) serves the G query heads of that
// kv head from one read of its cache (GQA without repeating the cache).
// Known limit of this first design: B * Hk blocks (32 at the full config) on
// 132 SMs underfill the card; splitting S across blocks (flash-decoding, with a
// second combine pass) is the fix a later change should measure.
//
// Layouts: q/out [B, H, Dh]; k/v cache [B, Hk, S, Dh]; k_new/v_new [B, Hk, Dh];
// scales [B, Hk, S] f32; start/pos [B] int32. Launches on the caller's stream,
// allocates nothing, does not synchronise; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;          // keys per shared-memory tile
constexpr float kNegInf = -1e9f;   // finite mask value, as the JAX package

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// shared memory (floats): q [G*DH] | acc [G*DH] | k [kTile*(DH+1)] |
// v [kTile*DH] | p [G*kTile] | m, l, alpha, pself [4*G]
template <int DH>
__host__ __device__ constexpr size_t smem_floats(int G) {
  return size_t(2 * G * DH + kTile * (DH + 1) + kTile * DH + G * kTile + 4 * G);
}

template <typename QT, typename CT, int DH>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const QT* __restrict__ q, const CT* __restrict__ kc,
                        const CT* __restrict__ vc, const QT* __restrict__ k_new,
                        const QT* __restrict__ v_new, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const int* __restrict__ start,
                        const int* __restrict__ pos, QT* __restrict__ out,
                        int H, int Hk, int S, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hk;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;

  float* q_s = smem;                       // [G][DH], pre-scaled
  float* acc_s = q_s + G * DH;             // [G][DH]
  float* k_s = acc_s + G * DH;             // [kTile][DH+1] (padded: no bank conflicts)
  float* v_s = k_s + kTile * (DH + 1);     // [kTile][DH]
  float* p_s = v_s + kTile * DH;           // [G][kTile]
  float* m_s = p_s + G * kTile;            // [G]
  float* l_s = m_s + G;                    // [G]
  float* alpha_s = l_s + G;                // [G]
  float* pself_s = alpha_s + G;            // [G]

  const int lo = max(start[b], 0);
  const int hi = min(pos[b], S);
  const size_t head = size_t(b) * Hk + hk;
  const CT* kbase = kc + head * size_t(S) * DH;
  const CT* vbase = vc + head * size_t(S) * DH;
  const float* ksc = k_scale ? k_scale + head * size_t(S) : nullptr;
  const float* vsc = v_scale ? v_scale + head * size_t(S) : nullptr;
  const size_t qoff = (size_t(b) * H + size_t(hk) * G) * DH;

  for (int i = tid; i < G * DH; i += kThreads) {
    q_s[i] = to_f32(q[qoff + i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = min(kTile, hi - t0);
    // stage the tile (contiguous rows t0..t0+n of this head) as float32
    for (int i = tid; i < n * DH; i += kThreads) {
      const int r = i / DH, d = i - r * DH;
      const size_t src = size_t(t0) * DH + i;
      k_s[r * (DH + 1) + d] = to_f32(kbase[src]);
      v_s[i] = to_f32(vbase[src]);
    }
    __syncthreads();
    // scores for (g, j)
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, j = i - g * kTile;
      float s = kNegInf;
      if (j < n) {
        const float* qr = q_s + g * DH;
        const float* kr = k_s + j * (DH + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = ksc ? dot * ksc[t0 + j] : dot;
      }
      p_s[i] = s;
    }
    __syncthreads();
    // online-softmax update, one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* pr = p_s + g * kTile;
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        const float e = j < n ? expf(pr[j] - m_new) : 0.f;
        sum += e;
        pr[j] = (vsc && j < n) ? e * vsc[t0 + j] : e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p @ V
    for (int i = tid; i < G * DH; i += kThreads) {
      const int g = i / DH, d = i - g * DH;
      const float* pr = p_s + g * kTile;
      float a = acc_s[i] * alpha_s[g];
      for (int j = 0; j < n; ++j) a = fmaf(pr[j], v_s[j * DH + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  // self-term: the current token's k/v (never quantised)
  const QT* kn = k_new + head * DH;
  const QT* vn = v_new + head * DH;
  for (int g = warp; g < G; g += kWarps) {
    float dot = 0.f;
    for (int d = lane; d < DH; d += 32) dot = fmaf(q_s[g * DH + d], to_f32(kn[d]), dot);
    dot = warp_sum(dot);
    if (lane == 0) {
      const float m_fin = fmaxf(m_s[g], dot);
      const float a = expf(m_s[g] - m_fin);
      const float ps = expf(dot - m_fin);
      alpha_s[g] = a;
      pself_s[g] = ps;
      l_s[g] = l_s[g] * a + ps;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i - g * DH;
    const float o = (acc_s[i] * alpha_s[g] + pself_s[g] * to_f32(vn[d])) / fmaxf(l_s[g], 1e-30f);
    from_f32(o, out + qoff + i);
  }
}

template <typename QT, typename CT, int DH>
int launch(const void* q, const void* k, const void* v, const void* kn, const void* vn,
           const float* ks, const float* vs, const int* start, const int* pos, void* out,
           int B, int H, int Hk, int S, float scale, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<QT, CT, DH>;
  const size_t bytes = smem_floats<DH>(H / Hk) * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(Hk, B), kThreads, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(k), static_cast<const CT*>(v),
      static_cast<const QT*>(kn), static_cast<const QT*>(vn), ks, vs, start, pos,
      static_cast<QT*>(out), H, Hk, S, scale);
  return cudaGetLastError();
}

template <typename QT, typename CT>
int dispatch_dh(int Dh, const void* q, const void* k, const void* v, const void* kn,
                const void* vn, const float* ks, const float* vs, const int* start,
                const int* pos, void* out, int B, int H, int Hk, int S, float scale,
                cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch<QT, CT, 32>(q, k, v, kn, vn, ks, vs, start, pos, out, B, H, Hk, S, scale, stream);
    case 64: return launch<QT, CT, 64>(q, k, v, kn, vn, ks, vs, start, pos, out, B, H, Hk, S, scale, stream);
    case 128: return launch<QT, CT, 128>(q, k, v, kn, vn, ks, vs, start, pos, out, B, H, Hk, S, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (cache only; scales given)
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* k_new, const void* v_new,
                                       const void* k_scale, const void* v_scale,
                                       const void* start, const void* pos, void* out,
                                       int B, int H, int Hk, int S, int Dh, int q_dtype,
                                       int cache_dtype, float scale, void* stream) {
  if (B <= 0 || Hk <= 0 || H % Hk != 0) return cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* st = static_cast<const int*>(start);
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && cache_dtype == 0)
    return dispatch_dh<float, float>(Dh, q, k, v, k_new, v_new, nullptr, nullptr, st, ps, out, B, H, Hk, S, scale, s);
  if (q_dtype == 1 && cache_dtype == 1)
    return dispatch_dh<__nv_bfloat16, __nv_bfloat16>(Dh, q, k, v, k_new, v_new, nullptr, nullptr, st, ps, out, B, H, Hk, S, scale, s);
  if (cache_dtype == 2 && ks != nullptr && vs != nullptr) {
    if (q_dtype == 0)
      return dispatch_dh<float, int8_t>(Dh, q, k, v, k_new, v_new, ks, vs, st, ps, out, B, H, Hk, S, scale, s);
    if (q_dtype == 1)
      return dispatch_dh<__nv_bfloat16, int8_t>(Dh, q, k, v, k_new, v_new, ks, vs, st, ps, out, B, H, Hk, S, scale, s);
  }
  return cudaErrorInvalidValue;
}
