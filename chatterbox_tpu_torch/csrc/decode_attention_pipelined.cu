// K3: single-query decode attention with the cache streamed through a cp.async
// ring, for Hopper (sm_90a).
//
// Replaces chatterbox_tpu/ops/pallas_attention_v3.py::
// paired_decode_attention_pipelined (kernel _pipelined_kernel). It computes
// K1's float body (decode_attention.cu without scales): for lane b and query
// head h (kv head hk = h / G), softmax over the cached keys in
// [start[b], pos[b]) plus the current token's k/v as a self-term, folded in
// before normalising; the finite -1e9 mask value is kept.
//
// The TPU kernel was one program that walked the batch rows in a loop and kept
// n_buf - 1 rows' K/V copies in flight in a VMEM ring, because one copy per
// row serialised on issue latency. What stands for it here:
//   - a persistent grid of at most one block per SM (fewer when B * Hk is
//     smaller); each block walks the work items (lane, kv head) in a strided
//     loop, which takes the place of the TPU kernel's row loop;
//   - each item's [start, pos) rows of K and V stream through a shared-memory
//     ring of kStages stages of kTile rows, filled with 16-byte cp.async.cg
//     copies and drained with cp.async.wait_group. The producer cursor runs
//     kStages - 1 tiles ahead of the consumer across item boundaries, so the
//     next item's first tiles are in flight while the current item computes;
//   - an online softmax in f32, with the self-term folded in at the end.
//
// What bounds it on the H100: bytes. G = 1 at the full config, so each cache
// element is used in one multiply-add for the scores or one for the output:
// far below the card's ~295 flop/byte balance point. The bound is the
// [start, pos) windows of K and V over 3.35 TB/s. TMA, mbarriers and tensor
// cores are left for a later change.
//
// Work split (128 threads): a score (g, j) is two half dot products over Dh/2,
// each read as 16-byte shared-memory loads from K rows padded by 16 bytes, so
// every quarter-warp phase is conflict-free; an output (g, d) is accumulated in
// registers by two threads, one per half of the tile's rows, and the halves are
// summed once per item.
//
// Layouts: q/out [B, H, Dh]; k/v cache [B, Hk, S, Dh]; k_new/v_new [B, Hk, Dh];
// start/pos [B] int32; cache and q share one dtype (bf16 or f32). Launches on
// the caller's stream, allocates nothing, does not synchronise; returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // cache rows per ring stage
constexpr int kHalf = kTile / 2;   // rows per accumulating half
constexpr int kMaxOut = 8;         // outputs per thread: 2 * G * Dh <= kThreads * kMaxOut
constexpr float kNegInf = -1e9f;   // finite mask value, as the JAX package

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// dot of q[0 : n] (f32, shared) with one cache half-row of n elements read as
// 16-byte chunks from shared memory
template <int N>
__device__ __forceinline__ float dot_row(const float* q, const unsigned char* k, float) {
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const float4 f = *reinterpret_cast<const float4*>(k + 16 * c);
    dot = fmaf(q[4 * c], f.x, dot);
    dot = fmaf(q[4 * c + 1], f.y, dot);
    dot = fmaf(q[4 * c + 2], f.z, dot);
    dot = fmaf(q[4 * c + 3], f.w, dot);
  }
  return dot;
}
template <int N>
__device__ __forceinline__ float dot_row(const float* q, const unsigned char* k, __nv_bfloat16) {
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    const uint4 raw = *reinterpret_cast<const uint4*>(k + 16 * c);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      dot = fmaf(q[8 * c + 2 * e], f.x, dot);
      dot = fmaf(q[8 * c + 2 * e + 1], f.y, dot);
    }
  }
  return dot;
}

template <typename T, int DH>
struct Ring {
  static constexpr int kRowBytes = DH * int(sizeof(T));  // one cache row
  static constexpr int kKRowBytes = kRowBytes + 16;      // padded K row in the ring
  static constexpr int kChunks = kRowBytes / 16;         // 16-byte copies per row
  static constexpr int kStageBytes = kTile * (kKRowBytes + kRowBytes);
  static constexpr int kStages = 4 * kStageBytes <= 160 * 1024 ? 4 : 3;
  static constexpr int kBytes = kStages * kStageBytes;
};

// float scratch after the ring: q [G*DH] | s_part [2][G][kTile] |
// p [G][kTile] | acc [2][G*DH] | m, l, alpha, pself [4*G]
__host__ __device__ constexpr size_t scratch_floats(int G, int DH) {
  return size_t(3 * G * DH + 3 * G * kTile + 4 * G);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
pipelined_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                 const T* __restrict__ k_new, const T* __restrict__ v_new,
                 const int* __restrict__ start, const int* __restrict__ pos,
                 T* __restrict__ out, int B, int H, int Hk, int S, float scale) {
  using R = Ring<T, DH>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / Hk;
  const int n_items = B * Hk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  unsigned char* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + R::kBytes);  // [G][DH], pre-scaled
  float* s_part = q_s + G * DH;                              // [2][G][kTile]
  float* p_s = s_part + 2 * G * kTile;                       // [G][kTile]
  float* acc_s = p_s + G * kTile;                            // [2][G*DH]
  float* m_s = acc_s + 2 * G * DH;                           // [G]
  float* l_s = m_s + G;                                      // [G]
  float* alpha_s = l_s + G;                                  // [G]
  float* pself_s = alpha_s + G;                              // [G]

  // item = b * Hk + hk is also the [B, Hk] head index of the cache
  auto window = [&](int item, int& lo, int& hi) {
    const int b = item / Hk;
    lo = max(start[b], 0);
    hi = min(pos[b], S);
  };

  // producer cursor: the next tile to copy, in the order the consumer reads
  // tiles (this block's items in turn, each item's rows in kTile steps)
  int p_item = blockIdx.x, p_row = 0, p_hi = 0, stage_in = 0;
  auto seek = [&]() {  // first item from p_item on with a non-empty window
    for (; p_item < n_items; p_item += gridDim.x) {
      int lo, hi;
      window(p_item, lo, hi);
      if (lo < hi) {
        p_row = lo;
        p_hi = hi;
        return;
      }
    }
  };
  // copy the next tile into stage stage_in and commit one group (an empty
  // group once every tile is in flight, so the group count stays uniform)
  auto issue = [&]() {
    if (p_item < n_items) {
      const size_t base = (size_t(p_item) * S + p_row) * R::kRowBytes;
      const unsigned char* kg = reinterpret_cast<const unsigned char*>(kc) + base;
      const unsigned char* vg = reinterpret_cast<const unsigned char*>(vc) + base;
      unsigned char* ks = ring + stage_in * R::kStageBytes;
      unsigned char* vs = ks + kTile * R::kKRowBytes;
      const int n = min(kTile, p_hi - p_row);
      for (int c = tid; c < n * R::kChunks; c += kThreads) {
        const int r = c / R::kChunks, w = c - r * R::kChunks;
        cp_async16(ks + r * R::kKRowBytes + 16 * w, kg + r * R::kRowBytes + 16 * w);
        cp_async16(vs + r * R::kRowBytes + 16 * w, vg + r * R::kRowBytes + 16 * w);
      }
      p_row += kTile;
      if (p_row >= p_hi) {
        p_item += gridDim.x;
        seek();
      }
    }
    cp_async_commit();
    stage_in = stage_in + 1 == R::kStages ? 0 : stage_in + 1;
  };

  seek();
  for (int s = 0; s < R::kStages - 1; ++s) issue();

  int stage_out = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int b = item / Hk;
    const int hk = item - b * Hk;
    int lo, hi;
    window(item, lo, hi);
    const size_t qoff = (size_t(b) * H + size_t(hk) * G) * DH;
    for (int i = tid; i < G * DH; i += kThreads) q_s[i] = to_f32(q[qoff + i]) * scale;
    for (int g = tid; g < G; g += kThreads) {
      m_s[g] = kNegInf;
      l_s[g] = 0.f;
    }
    float acc[kMaxOut];
#pragma unroll
    for (int k = 0; k < kMaxOut; ++k) acc[k] = 0.f;
    __syncthreads();

    for (int t0 = lo; t0 < hi; t0 += kTile) {
      const int n = min(kTile, hi - t0);
      issue();                            // refills the stage freed last step
      cp_async_wait<R::kStages - 1>();    // this thread's copies of this tile
      __syncthreads();                    // everyone's copies of this tile
      const unsigned char* ks = ring + stage_out * R::kStageBytes;
      const unsigned char* vs = ks + kTile * R::kKRowBytes;

      // half scores: p -> (row j, head g, half h)
      for (int p = tid; p < 2 * G * kTile; p += kThreads) {
        const int j = p % kTile;
        const int g = (p / kTile) % G;
        const int h = p / (kTile * G);
        float dot = 0.f;
        if (j < n)
          dot = dot_row<DH / 2>(q_s + g * DH + h * (DH / 2),
                                ks + j * R::kKRowBytes + h * (R::kRowBytes / 2), T());
        s_part[p] = dot;
      }
      __syncthreads();
      // online-softmax update, one warp per query head
      for (int g = warp; g < G; g += kWarps) {
        float* pr = p_s + g * kTile;
        float mx = kNegInf;
        for (int j = lane; j < kTile; j += 32) {
          const float s = j < n ? s_part[g * kTile + j] + s_part[(G + g) * kTile + j] : kNegInf;
          pr[j] = s;
          mx = fmaxf(mx, s);
        }
        mx = warp_max(mx);
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int j = lane; j < kTile; j += 32) {
          const float e = j < n ? expf(pr[j] - m_new) : 0.f;
          sum += e;
          pr[j] = e;
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
      // acc = acc * alpha + p @ V over this thread's half of the rows
#pragma unroll
      for (int k = 0; k < kMaxOut; ++k) {
        const int o = tid + k * kThreads;
        if (o < 2 * G * DH) {
          const int d = o % DH;
          const int g = (o / DH) % G;
          const int h = o / (G * DH);
          const float* pr = p_s + g * kTile;
          float a = acc[k] * alpha_s[g];
          const int j1 = min(n, (h + 1) * kHalf);
          for (int j = h * kHalf; j < j1; ++j)
            a = fmaf(pr[j], to_f32(reinterpret_cast<const T*>(vs + j * R::kRowBytes)[d]), a);
          acc[k] = a;
        }
      }
      __syncthreads();                    // the stage may be refilled now
      stage_out = stage_out + 1 == R::kStages ? 0 : stage_out + 1;
    }

    // both halves to shared memory; the self-term joins the max and the sum
#pragma unroll
    for (int k = 0; k < kMaxOut; ++k) {
      const int o = tid + k * kThreads;
      if (o < 2 * G * DH) acc_s[o] = acc[k];
    }
    const T* kn = k_new + size_t(item) * DH;
    const T* vn = v_new + size_t(item) * DH;
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
      const float a = acc_s[i] + acc_s[G * DH + i];
      const float o = (a * alpha_s[g] + pself_s[g] * to_f32(vn[d])) / fmaxf(l_s[g], 1e-30f);
      from_f32(o, out + qoff + i);
    }
    __syncthreads();                      // scratch is reused by the next item
  }
  cp_async_wait<0>();
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* kn, const void* vn,
           const int* start, const int* pos, void* out, int B, int H, int Hk, int S,
           int n_sm, float scale, cudaStream_t stream) {
  const int G = H / Hk;
  if (2 * G * DH > kThreads * kMaxOut) return cudaErrorInvalidValue;
  auto kernel = pipelined_kernel<T, DH>;
  const size_t bytes = Ring<T, DH>::kBytes + scratch_floats(G, DH) * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  const int grid = B * Hk < n_sm ? B * Hk : n_sm;  // persistent: at most one block per SM
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(kn), static_cast<const T*>(vn), start, pos, static_cast<T*>(out),
      B, H, Hk, S, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch_dh(int Dh, const void* q, const void* k, const void* v, const void* kn,
                const void* vn, const int* start, const int* pos, void* out, int B, int H,
                int Hk, int S, int n_sm, float scale, cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch<T, 32>(q, k, v, kn, vn, start, pos, out, B, H, Hk, S, n_sm, scale, stream);
    case 64: return launch<T, 64>(q, k, v, kn, vn, start, pos, out, B, H, Hk, S, n_sm, scale, stream);
    case 128: return launch<T, 128>(q, k, v, kn, vn, start, pos, out, B, H, Hk, S, n_sm, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, cache, k_new, v_new and out alike)
extern "C" int decode_attention_pipelined_launch(const void* q, const void* k, const void* v,
                                                 const void* k_new, const void* v_new,
                                                 const void* start, const void* pos, void* out,
                                                 int B, int H, int Hk, int S, int Dh, int dtype,
                                                 int n_sm, float scale, void* stream) {
  if (B <= 0 || Hk <= 0 || H % Hk != 0 || n_sm <= 0) return cudaErrorInvalidValue;
  const int* st = static_cast<const int*>(start);
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(Dh, q, k, v, k_new, v_new, st, ps, out, B, H, Hk, S, n_sm, scale, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(Dh, q, k, v, k_new, v_new, st, ps, out, B, H, Hk, S, n_sm, scale, s);
  return cudaErrorInvalidValue;
}
