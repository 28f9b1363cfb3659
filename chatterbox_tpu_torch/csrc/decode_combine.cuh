// The split-S partials of decode attention, shared by K1
// (decode_attention.cu) and K3 (decode_attention_pipelined.cu): how a slice
// block stores its partial, and the combine step that folds them.
//
// Both kernels' slice blocks write one partial per (lane, kv head, slice,
// query head of the group): the running max m of the scores in the log2
// domain, the sum l of exp2(score - m) and the accumulator acc = sum of
// exp2(score - m) * v. A slice without rows in the window writes l = 0. One
// block per (kv head, lane) then folds the partials and the current token's
// self-term, weighting each partial by exp2(m - M) and skipping those with
// l = 0 (their m is the mask value, never a real score), and writes the
// output. The number of query heads per kv head, G, is a template argument
// of the combine (as K1 compiles it), or 0 for one given at run time.
//
// Layouts: q/out [B, H, Dh]; k_new/v_new [B, Hk, Dh]; part_acc
// [B, Hk, n_slice, G, Dh] and part_ml [B, Hk, n_slice, G, 2] in f32.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;   // finite mask value, as the JAX package
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kCombineThreads = 128;
constexpr int kMaxGroup = 16;      // query heads per kv head: G * Dh <= 512, Dh >= 32

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }

// the 16-byte chunk of 4 f32, 8 bf16 or 16 int8 cache values, as f32
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[16]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    x[i] = static_cast<float>(static_cast<int8_t>((w[i >> 2] >> (8 * (i & 3))) & 0xffu));
}

// The empty partial (l = 0) of query heads part .. part + G - 1, written by a
// block of kThreads threads whose slice has no rows in the window.
template <int G, int DH, int kThreads>
__device__ __forceinline__ void store_empty_partial(float* __restrict__ part_acc,
                                                    float* __restrict__ part_ml, size_t part) {
  for (int i = threadIdx.x; i < G * DH; i += kThreads) part_acc[part * DH + i] = 0.f;
  if (threadIdx.x < G) {
    part_ml[(part + threadIdx.x) * 2] = kNegInf;
    part_ml[(part + threadIdx.x) * 2 + 1] = 0.f;
  }
}

// Fold a block's kWarps warps into the slice's partial of query heads
// part .. part + G - 1 and store it. In each warp, lane = sub * R + c holds
// chunk c (E values of a head's Dh) of the sums over its own rows; m is
// uniform across the warp. One barrier; a warp without rows (l = 0) is
// skipped.
template <int G, int DH, int E, int R, int kWarps>
__device__ __forceinline__ void store_partial(const float (&m)[G], float (&l)[G],
                                              float (&acc)[G][E], float* __restrict__ part_acc,
                                              float* __restrict__ part_ml, size_t part) {
  __shared__ float red_m[kWarps][G], red_l[kWarps][G], red_acc[kWarps][G][DH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / R, c = lane % R;
  // fold the warp: lanes of one chunk (same c) hold partials over their rows
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int o = R; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
    if (sub == 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) red_acc[warp][g][c * E + e] = acc[g][e];
      if (c == 0) {
        red_m[warp][g] = m[g];
        red_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  // fold the block's warps into the slice's partial
  for (int i = threadIdx.x; i < G * DH; i += kWarps * 32) {
    const int g = i / DH, d = i - g * DH;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (red_l[w][g] > 0.f) mx = fmaxf(mx, red_m[w][g]);
    float a = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (red_l[w][g] > 0.f) {
        const float wt = exp2f(red_m[w][g] - mx);
        a = fmaf(wt, red_acc[w][g][d], a);
        sum = fmaf(wt, red_l[w][g], sum);
      }
    }
    part_acc[part * DH + i] = a;
    if (d == 0) {
      part_ml[(part + g) * 2] = mx;
      part_ml[(part + g) * 2 + 1] = sum;
    }
  }
}

template <typename QT, int DH, int kG>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const QT* __restrict__ q, const QT* __restrict__ k_new,
                      const QT* __restrict__ v_new, const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, QT* __restrict__ out, int H, int Hk,
                      int g_run, int n_slice, float scale) {
  constexpr int kWarps = kCombineThreads / 32;
  const int G = kG > 0 ? kG : g_run;
  __shared__ float s_self[kG > 0 ? kG : kMaxGroup];
  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t head = size_t(b) * Hk + hk;
  const size_t qoff = (size_t(b) * H + size_t(hk) * G) * DH;
  const QT* kn = k_new + head * DH;
  const QT* vn = v_new + head * DH;
  for (int g = warp; g < G; g += kWarps) {
    float d = 0.f;
    for (int i = lane; i < DH; i += 32) d = fmaf(to_f32(q[qoff + g * DH + i]), to_f32(kn[i]), d);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (lane == 0) s_self[g] = d * (scale * kLog2e);
  }
  __syncthreads();
  const size_t part0 = head * n_slice * G;
  for (int i = threadIdx.x; i < G * DH; i += kCombineThreads) {
    const int g = i / DH, d = i - g * DH;
    const float ss = s_self[g];
    float mx = ss;
    for (int sl = 0; sl < n_slice; ++sl) {
      const float* ml = part_ml + (part0 + size_t(sl) * G + g) * 2;
      if (ml[1] > 0.f) mx = fmaxf(mx, ml[0]);
    }
    const float ps = exp2f(ss - mx);
    float num = ps * to_f32(vn[d]), den = ps;
    for (int sl = 0; sl < n_slice; ++sl) {
      const size_t p = part0 + size_t(sl) * G + g;
      const float* ml = part_ml + p * 2;
      if (ml[1] > 0.f) {
        const float wt = exp2f(ml[0] - mx);
        num = fmaf(wt, part_acc[p * DH + d], num);
        den = fmaf(wt, ml[1], den);
      }
    }
    from_f32(num / den, out + qoff + i);
  }
}

// The combine over one call's partials, on the caller's stream; kG as for
// decode_combine_kernel.
template <typename QT, int DH, int kG>
cudaError_t launch_combine(const void* q, const void* k_new, const void* v_new,
                           const float* part_acc, const float* part_ml, void* out, int B,
                           int H, int Hk, int n_slice, float scale, cudaStream_t stream) {
  const int G = H / Hk;
  if (G > kMaxGroup || (kG > 0 && G != kG)) return cudaErrorInvalidValue;
  decode_combine_kernel<QT, DH, kG><<<dim3(Hk, B), kCombineThreads, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const QT*>(k_new), static_cast<const QT*>(v_new),
      part_acc, part_ml, static_cast<QT*>(out), H, Hk, G, n_slice, scale);
  return cudaGetLastError();
}

}  // namespace
