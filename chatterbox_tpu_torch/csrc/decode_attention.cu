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
// What bounds it on the H100: bytes. Each step reads the filled cache window
// (2 * (pos - start) * Dh elements per (lane, kv head)) and does ~4 flops per
// element, far below the card's ~295 flop/byte balance point, so the kernel is
// a memory stream, and a stream needs many bytes in flight. At the batched
// decoder's shapes (32 lanes x 16 kv heads, windows of ~600 rows) one block
// per (lane, kv head) walking ten 64-row tiles in turn, with four barriers per
// tile, left the card mostly waiting; instead the design is split-S flash
// decoding:
//   - the grid is (slice, kv head, lane), a slice being kSlice = 256 cache rows
//     (ceil(S / 256) slices, from S alone: nothing is read on the host; 2,560
//     blocks at S = 1280). A block reads only its slice's part of [start,
//     pos); a block whose part is empty writes an empty partial (l = 0) and
//     exits. Of 64, 128, 256 and 512 rows, 256 was the fastest at the batched
//     windows on an H100;
//   - each lane loads 16 bytes per row chunk (16 int8 or 8 bf16 values), a
//     warp owns whole rows, scores are reduced with warp shuffles, and the
//     online-softmax state and the accumulator stay in registers. The next
//     tile's loads are issued before the current tile's math (a register
//     double buffer); nothing is staged in shared memory, and the block's one
//     barrier folds its four warps into one partial (m, l, acc) in f32;
//   - the G query heads of a kv head share each read of its rows;
//   - a second small kernel, one block per (lane, kv head), folds the partials
//     and the self-term, weighting each partial by exp(m - M) and skipping
//     those with l = 0, and writes the output (decode_combine.cuh, shared
//     with K3).
//
// Layouts: q/out [B, H, Dh]; k/v cache [B, Hk, S, Dh]; k_new/v_new [B, Hk, Dh];
// scales [B, Hk, S] f32; start/pos [B] int32; scratch (f32) holds the partials
// acc [B, Hk, n_slice, G, Dh] then (m, l) [B, Hk, n_slice, G, 2]. Launches on
// the caller's stream, allocates nothing, does not synchronise; returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "decode_combine.cuh"

namespace {

constexpr int kSlice = 256;        // cache rows per block
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 2;          // row loads per warp per tile (K and V each)

template <typename CT>
struct Tile {   // one lane's share of a tile: kSteps rows of K and V (+ int8 scales)
  uint4 k[kSteps], v[kSteps];
  float ks[kSteps], vs[kSteps];
  bool in[kSteps];
};

template <typename QT, typename CT, int DH, int G>
__global__ void __launch_bounds__(kThreads)
decode_slice_kernel(const QT* __restrict__ q, const CT* __restrict__ kc,
                    const CT* __restrict__ vc, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ start,
                    const int* __restrict__ pos, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int H, int Hk, int S, int n_slice,
                    float scale) {
  constexpr bool kInt8 = std::is_same<CT, int8_t>::value;
  constexpr int E = 16 / sizeof(CT);       // values per 16-byte chunk
  constexpr int R = DH / E;                // lanes per cache row
  constexpr int RPL = 32 / R;              // rows per warp load
  constexpr int kTileRows = kWarps * kSteps * RPL;
  static_assert(R >= 1 && R <= 32 && kSlice % kTileRows == 0, "unsupported head dim");

  const int sl = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / R;    // row of the warp load
  const int c = lane % R;      // chunk of the row
  const int s0 = sl * kSlice;
  const int lo = max(max(start[b], 0), s0);
  const int hi = min(min(pos[b], S), s0 + kSlice);
  const size_t head = size_t(b) * Hk + hk;
  const size_t part = (head * n_slice + sl) * G;   // partial of query head g: part + g

  if (lo >= hi) {
    store_empty_partial<G, DH, kThreads>(part_acc, part_ml, part);
    return;
  }

  const CT* kbase = kc + head * size_t(S) * DH + c * E;
  const CT* vbase = vc + head * size_t(S) * DH + c * E;
  const float* ksc = kInt8 ? k_scale + head * size_t(S) : nullptr;
  const float* vsc = kInt8 ? v_scale + head * size_t(S) : nullptr;

  // this lane's chunk of each query head, pre-scaled into the log2 domain
  float qr[G][E];
  const QT* qh = q + (size_t(b) * H + size_t(hk) * G) * DH + c * E;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) qr[g][e] = to_f32(qh[g * DH + e]) * (scale * kLog2e);

  auto load = [&](Tile<CT>& t, int tile) {
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int row = s0 + tile * kTileRows + (warp * kSteps + st) * RPL + sub;
      t.in[st] = row >= lo && row < hi;
      if (t.in[st]) {
        t.k[st] = *reinterpret_cast<const uint4*>(kbase + size_t(row) * DH);
        t.v[st] = *reinterpret_cast<const uint4*>(vbase + size_t(row) * DH);
        if constexpr (kInt8) {
          t.ks[st] = ksc[row];
          t.vs[st] = vsc[row];
        }
      } else {
        t.k[st] = t.v[st] = make_uint4(0u, 0u, 0u, 0u);
        t.ks[st] = t.vs[st] = 0.f;
      }
    }
  };

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  auto compute = [&](const Tile<CT>& t) {
    float s[kSteps][G];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      float kx[E];
      unpack(t.k[st], kx);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[g][e], kx[e], d);
#pragma unroll
        for (int o = 1; o < R; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if constexpr (kInt8) d *= t.ks[st];
        s[st][g] = t.in[st] ? d : kNegInf;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int st = 1; st < kSteps; ++st) mx = fmaxf(mx, s[st][g]);
#pragma unroll
      for (int o = R; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = exp2f(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      float vx[E];
      unpack(t.v[st], vx);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = t.in[st] ? exp2f(s[st][g] - m[g]) : 0.f;
        l[g] += p;
        const float pv = kInt8 ? p * t.vs[st] : p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pv, vx[e], acc[g][e]);
      }
    }
  };

  // the tiles of this slice that meet [lo, hi), two in flight at a time
  const int t_end = (hi - s0 + kTileRows - 1) / kTileRows;
  Tile<CT> ta, tb;
  int ti = (lo - s0) / kTileRows;
  load(ta, ti);
  while (true) {
    if (ti + 1 < t_end) load(tb, ti + 1);
    compute(ta);
    if (++ti >= t_end) break;
    if (ti + 1 < t_end) load(ta, ti + 1);
    compute(tb);
    if (++ti >= t_end) break;
  }

  store_partial<G, DH, E, R, kWarps>(m, l, acc, part_acc, part_ml, part);
}

template <typename QT, typename CT, int DH, int G>
int launch(const void* q, const void* k, const void* v, const void* kn, const void* vn,
           const float* ks, const float* vs, const int* start, const int* pos, void* out,
           float* scratch, int B, int Hk, int S, float scale, cudaStream_t stream) {
  const int H = Hk * G;
  const int n_slice = (S + kSlice - 1) / kSlice;
  float* part_acc = scratch;
  float* part_ml = scratch + size_t(B) * Hk * n_slice * G * DH;
  decode_slice_kernel<QT, CT, DH, G><<<dim3(n_slice, Hk, B), kThreads, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(k), static_cast<const CT*>(v), ks, vs,
      start, pos, part_acc, part_ml, H, Hk, S, n_slice, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_combine<QT, DH, G>(q, kn, vn, part_acc, part_ml, out, B, H, Hk, n_slice, scale,
                                   stream);
}

template <typename QT, typename CT, int DH>
int dispatch_g(int G, const void* q, const void* k, const void* v, const void* kn,
               const void* vn, const float* ks, const float* vs, const int* start,
               const int* pos, void* out, float* scratch, int B, int Hk, int S, float scale,
               cudaStream_t stream) {
  switch (G) {
    case 1: return launch<QT, CT, DH, 1>(q, k, v, kn, vn, ks, vs, start, pos, out, scratch, B, Hk, S, scale, stream);
    case 2: return launch<QT, CT, DH, 2>(q, k, v, kn, vn, ks, vs, start, pos, out, scratch, B, Hk, S, scale, stream);
    case 4: return launch<QT, CT, DH, 4>(q, k, v, kn, vn, ks, vs, start, pos, out, scratch, B, Hk, S, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT, typename CT>
int dispatch_dh(int Dh, int G, const void* q, const void* k, const void* v, const void* kn,
                const void* vn, const float* ks, const float* vs, const int* start,
                const int* pos, void* out, float* scratch, int B, int Hk, int S, float scale,
                cudaStream_t stream) {
  switch (Dh) {
    case 32: return dispatch_g<QT, CT, 32>(G, q, k, v, kn, vn, ks, vs, start, pos, out, scratch, B, Hk, S, scale, stream);
    case 64: return dispatch_g<QT, CT, 64>(G, q, k, v, kn, vn, ks, vs, start, pos, out, scratch, B, Hk, S, scale, stream);
    case 128: return dispatch_g<QT, CT, 128>(G, q, k, v, kn, vn, ks, vs, start, pos, out, scratch, B, Hk, S, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Cache rows per slice: the wrapper sizes the scratch as
// B * Hk * ceil(S / rows) * G * (Dh + 2) floats.
extern "C" int decode_attention_slice_rows() { return kSlice; }

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (cache only; scales given)
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* k_new, const void* v_new,
                                       const void* k_scale, const void* v_scale,
                                       const void* start, const void* pos, void* out,
                                       void* scratch, int B, int H, int Hk, int S, int Dh,
                                       int q_dtype, int cache_dtype, float scale,
                                       void* stream) {
  if (B <= 0 || Hk <= 0 || S <= 0 || H % Hk != 0) return cudaErrorInvalidValue;
  const int G = H / Hk;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* st = static_cast<const int*>(start);
  const int* ps = static_cast<const int*>(pos);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && cache_dtype == 0)
    return dispatch_dh<float, float>(Dh, G, q, k, v, k_new, v_new, nullptr, nullptr, st, ps, out, sc, B, Hk, S, scale, s);
  if (q_dtype == 1 && cache_dtype == 1)
    return dispatch_dh<__nv_bfloat16, __nv_bfloat16>(Dh, G, q, k, v, k_new, v_new, nullptr, nullptr, st, ps, out, sc, B, Hk, S, scale, s);
  if (cache_dtype == 2 && ks != nullptr && vs != nullptr) {
    if (q_dtype == 0)
      return dispatch_dh<float, int8_t>(Dh, G, q, k, v, k_new, v_new, ks, vs, st, ps, out, sc, B, Hk, S, scale, s);
    if (q_dtype == 1)
      return dispatch_dh<__nv_bfloat16, int8_t>(Dh, G, q, k, v, k_new, v_new, ks, vs, st, ps, out, sc, B, Hk, S, scale, s);
  }
  return cudaErrorInvalidValue;
}
