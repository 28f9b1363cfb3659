// K3: single-query decode attention with the cache streamed into shared
// memory by the Tensor Memory Accelerator, for Hopper (sm_90a).
//
// Replaces chatterbox_tpu/ops/pallas_attention_v3.py::
// paired_decode_attention_pipelined (kernel _pipelined_kernel). It computes
// K1's float body (decode_attention.cu without scales): for lane b and query
// head h (kv head hk = h / G), softmax over the cached keys in
// [start[b], pos[b]) plus the current token's k/v as a self-term, folded in
// before normalising; the finite -1e9 mask value is kept.
//
// What bounds it on the H100: bytes. G = 1 at the full config, so each cache
// element is used in one multiply-add for the scores or one for the output:
// far below the card's ~295 flop/byte balance point. The bound is the
// [start, pos) windows of K and V over 3.35 TB/s, and a stream reaches it
// only with many bytes in flight on every SM.
//
// The TPU kernel's point was a copy engine that runs ahead of the math: it
// kept n_buf - 1 rows' K/V copies in flight in a VMEM ring
// (make_async_copy and DMA semaphores). The Tensor Memory Accelerator is
// Hopper's counterpart, so this kernel keeps that shape inside K1's split-S
// grid:
//   - the grid is (slice, kv head x head chunk, lane), a slice being kSlice
//     = 512 cache rows (ceil(S / kSlice) slices, from S alone: nothing is
//     read on the host; 1,536 blocks at S = 1280). A block reads only its
//     slice's part [lo, hi) of [start, pos); a block whose part is empty
//     writes an empty partial (l = 0) and exits;
//   - [lo, hi) of K in [B, Hk, S, Dh] is one contiguous run of bytes, and so
//     is its run of V. The block cuts them into tiles of kTileBytes of K
//     (and as many of V) from lo on, and streams the tiles through a ring of
//     kStages stages in shared memory. One thread arms the stage's "full"
//     mbarrier with the tile's bytes (mbarrier.arrive.expect_tx) and issues
//     one 1-D bulk copy (cp.async.bulk ... mbarrier::complete_tx::bytes) for
//     K's rows and one for V's; no tensor map is needed. Every thread waits
//     on the stage's phase (mbarrier.try_wait.parity), computes the tile,
//     and one __syncthreads() per refill frees the stage before the thread
//     copies the tile kStages ahead into it. The rows are unpadded, as a bulk
//     copy cannot pad them. Of slices of 128, 256 and 512 rows, tiles of 8
//     and 16 KB and 2, 3 and 4 stages (chip_k3_sweep.py), 512 / 8 KB / 2
//     came within 1 % of the fastest on an H100, in bf16 and f32, at the
//     batched decoder's windows and at windows of 111-202 rows; 256-row
//     slices did as well, and deeper rings and larger tiles gained nothing
//     or lost;
//   - the math is K1's: each lane reads 16-byte chunks of a row (a warp load
//     is 512 contiguous bytes, conflict-free), a warp owns whole rows, scores
//     are reduced with warp shuffles, and the online-softmax state and the
//     accumulator stay in f32 registers. The GC query heads a block serves
//     share each row it reads. G > 4 is split into chunks of GC heads, one
//     block each, so the registers stay bounded; the chunks of a kv head
//     read its rows from L2;
//   - one barrier at the end folds the block's four warps into one partial
//     (m, l, acc), and the slices' partials and the self-term are folded by
//     the combine kernel, both from decode_combine.cuh, as for K1.
// K1 loads its rows straight into registers, one warp load ahead: its int8
// rows are a quarter of the bytes, and a register double buffer keeps enough
// in flight. Here whole tiles are in flight per block while the warps
// compute, with no registers and no instructions spent on the copies.
//
// Layouts: q/out [B, H, Dh]; k/v cache [B, Hk, S, Dh]; k_new/v_new [B, Hk, Dh];
// start/pos [B] int32; cache and q share one dtype (bf16 or f32); scratch
// (f32) holds the partials acc [B, Hk, n_slice, G, Dh] then (m, l)
// [B, Hk, n_slice, G, 2]. The cache must start on 16 bytes. Launches on the
// caller's stream, allocates nothing, does not synchronise; returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "decode_combine.cuh"

namespace {

constexpr int kSlice = 512;        // cache rows per block
constexpr int kTileBytes = 8192;   // bytes of K (and of V) per ring stage
constexpr int kStages = 2;         // ring stages per block
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 2;          // warp loads per softmax update

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` more to land before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory; completion is counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T, int DH>
struct Geometry {
  static constexpr int kRowBytes = DH * int(sizeof(T));
  static constexpr int kE = 16 / int(sizeof(T));     // values per 16-byte chunk
  static constexpr int kR = DH / kE;                 // lanes per cache row
  static constexpr int kRowsPerLoad = 32 / kR;       // rows per warp load
  static constexpr int kTile = kTileBytes / kRowBytes;  // cache rows per stage
  static constexpr int kLoads = kTile / kRowsPerLoad / kWarps;  // per warp per tile
  static constexpr int kRingBytes = kStages * 2 * kTileBytes;   // K then V per stage
  static_assert(kR >= 1 && kR <= 32 && kTile % (kRowsPerLoad * kWarps) == 0 &&
                    kLoads % kSteps == 0,
                "unsupported head dim");
};

template <typename T, int DH, int GC>
__global__ void __launch_bounds__(kThreads)
pipelined_slice_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                       const T* __restrict__ vc, const int* __restrict__ start,
                       const int* __restrict__ pos, float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int H, int Hk, int S, int n_slice,
                       int n_chunk, float scale) {
  using Geo = Geometry<T, DH>;
  constexpr int E = Geo::kE, R = Geo::kR, RPL = Geo::kRowsPerLoad;
  extern __shared__ __align__(128) unsigned char ring[];   // [kStages][K tile | V tile]
  __shared__ __align__(8) uint64_t full[kStages];

  const int sl = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / n_chunk, chunk = blockIdx.y - hk * n_chunk;
  const int G = H / Hk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane / R;    // row of the warp load
  const int c = lane % R;      // chunk of the row
  const int s0 = sl * kSlice;
  const int lo = max(max(start[b], 0), s0);
  const int hi = min(min(pos[b], S), s0 + kSlice);
  const size_t head = size_t(b) * Hk + hk;
  // partial of query head chunk * GC + g: part + g
  const size_t part = (head * n_slice + sl) * G + size_t(chunk) * GC;

  if (lo >= hi) {
    store_empty_partial<GC, DH, kThreads>(part_acc, part_ml, part);
    return;
  }

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const unsigned char* kg = reinterpret_cast<const unsigned char*>(kc + head * size_t(S) * DH);
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(vc + head * size_t(S) * DH);
  const int n_tiles = (hi - lo + Geo::kTile - 1) / Geo::kTile;
  // thread 0: arm tile t's stage and copy its rows of K and V
  auto issue = [&](int t) {
    const int row0 = lo + t * Geo::kTile;
    const uint32_t bytes = uint32_t(min(Geo::kTile, hi - row0)) * Geo::kRowBytes;
    unsigned char* st = ring + (t % kStages) * 2 * kTileBytes;
    uint64_t* bar = &full[t % kStages];
    mbar_arrive_expect_tx(bar, 2 * bytes);
    bulk_copy(st, kg + size_t(row0) * Geo::kRowBytes, bytes, bar);
    bulk_copy(st + kTileBytes, vg + size_t(row0) * Geo::kRowBytes, bytes, bar);
  };
  if (tid == 0)
    for (int t = 0; t < min(kStages, n_tiles); ++t) issue(t);

  // this lane's chunk of each query head, pre-scaled into the log2 domain
  float qr[GC][E];
  const T* qh = q + (size_t(b) * H + size_t(hk) * G + size_t(chunk) * GC) * DH + c * E;
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) qr[g][e] = to_f32(qh[g * DH + e]) * (scale * kLog2e);

  float m[GC], l[GC], acc[GC][E];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int n = min(Geo::kTile, hi - lo - t * Geo::kTile);   // rows in this tile
    mbar_wait(&full[t % kStages], (t / kStages) & 1);
    const unsigned char* ks = ring + (t % kStages) * 2 * kTileBytes;
    const unsigned char* vs = ks + kTileBytes;
    // warp load i of this warp covers rows (i * kWarps + warp) * RPL + [0, RPL)
#pragma unroll
    for (int i = 0; i < Geo::kLoads; i += kSteps) {
      if ((i * kWarps + warp) * RPL >= n) break;    // warp-uniform: later loads are further on
      uint4 kx4[kSteps], vx4[kSteps];
      bool in[kSteps];
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int row = ((i + st) * kWarps + warp) * RPL + sub;
        in[st] = row < n;   // rows past n hold an older tile (or nothing yet)
        const size_t off = size_t(row) * Geo::kRowBytes + 16 * c;
        kx4[st] = in[st] ? *reinterpret_cast<const uint4*>(ks + off) : make_uint4(0u, 0u, 0u, 0u);
        vx4[st] = in[st] ? *reinterpret_cast<const uint4*>(vs + off) : make_uint4(0u, 0u, 0u, 0u);
      }
      float s[kSteps][GC];
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        float kx[E];
        unpack(kx4[st], kx);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) d = fmaf(qr[g][e], kx[e], d);
#pragma unroll
          for (int o = 1; o < R; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
          s[st][g] = in[st] ? d : kNegInf;
        }
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
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
        unpack(vx4[st], vx);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float p = in[st] ? exp2f(s[st][g] - m[g]) : 0.f;
          l[g] += p;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vx[e], acc[g][e]);
        }
      }
    }
    if (t + kStages < n_tiles) {
      __syncthreads();              // every warp is done with this stage
      if (tid == 0) issue(t + kStages);
    }
  }

  store_partial<GC, DH, E, R, kWarps>(m, l, acc, part_acc, part_ml, part);
}

template <typename T, int DH, int GC>
int launch(const void* q, const void* k, const void* v, const void* kn, const void* vn,
           const int* start, const int* pos, void* out, float* scratch, int B, int H, int Hk,
           int S, float scale, cudaStream_t stream) {
  const int G = H / Hk;
  const int n_chunk = G / GC;
  const int n_slice = (S + kSlice - 1) / kSlice;
  float* part_acc = scratch;
  float* part_ml = scratch + size_t(B) * Hk * n_slice * G * DH;
  auto kernel = pipelined_slice_kernel<T, DH, GC>;
  constexpr int bytes = Geometry<T, DH>::kRingBytes;
  constexpr int static_bytes = kStages * 8 + kWarps * GC * (DH + 2) * 4;   // barriers, fold
  if (bytes + static_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  if (n_slice > 0) {   // S = 0 leaves the self-term alone
    kernel<<<dim3(n_slice, Hk * n_chunk, B), kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), start,
        pos, part_acc, part_ml, H, Hk, S, n_slice, n_chunk, scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (n_chunk == 1)
    return launch_combine<T, DH, GC>(q, kn, vn, part_acc, part_ml, out, B, H, Hk, n_slice, scale,
                                     stream);
  return launch_combine<T, DH, 0>(q, kn, vn, part_acc, part_ml, out, B, H, Hk, n_slice, scale,
                                  stream);
}

// query heads per block: the largest of 4, 2, 1 that divides G
template <typename T, int DH>
int dispatch_gc(const void* q, const void* k, const void* v, const void* kn, const void* vn,
                const int* start, const int* pos, void* out, float* scratch, int B, int H,
                int Hk, int S, float scale, cudaStream_t stream) {
  const int G = H / Hk;
  if (G % 4 == 0) return launch<T, DH, 4>(q, k, v, kn, vn, start, pos, out, scratch, B, H, Hk, S, scale, stream);
  if (G % 2 == 0) return launch<T, DH, 2>(q, k, v, kn, vn, start, pos, out, scratch, B, H, Hk, S, scale, stream);
  return launch<T, DH, 1>(q, k, v, kn, vn, start, pos, out, scratch, B, H, Hk, S, scale, stream);
}

template <typename T>
int dispatch_dh(int Dh, const void* q, const void* k, const void* v, const void* kn,
                const void* vn, const int* start, const int* pos, void* out, float* scratch,
                int B, int H, int Hk, int S, float scale, cudaStream_t stream) {
  switch (Dh) {
    case 32: return dispatch_gc<T, 32>(q, k, v, kn, vn, start, pos, out, scratch, B, H, Hk, S, scale, stream);
    case 64: return dispatch_gc<T, 64>(q, k, v, kn, vn, start, pos, out, scratch, B, H, Hk, S, scale, stream);
    case 128: return dispatch_gc<T, 128>(q, k, v, kn, vn, start, pos, out, scratch, B, H, Hk, S, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Cache rows per slice: the wrapper sizes the scratch as
// B * Hk * ceil(S / rows) * G * (Dh + 2) floats.
extern "C" int decode_attention_pipelined_slice_rows() { return kSlice; }

// Stages of the ring.
extern "C" int decode_attention_pipelined_stages() { return kStages; }

// Cache rows per ring stage at head dim Dh and dtype code `dtype`.
extern "C" int decode_attention_pipelined_tile_rows(int Dh, int dtype) {
  const int elem = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  return elem > 0 && Dh > 0 ? kTileBytes / (Dh * elem) : 0;
}

// dtype codes: 0 = float32, 1 = bfloat16 (q, cache, k_new, v_new and out alike)
extern "C" int decode_attention_pipelined_launch(const void* q, const void* k, const void* v,
                                                 const void* k_new, const void* v_new,
                                                 const void* start, const void* pos, void* out,
                                                 void* scratch, int B, int H, int Hk, int S,
                                                 int Dh, int dtype, float scale, void* stream) {
  if (B <= 0 || Hk <= 0 || S < 0 || H % Hk != 0 || H / Hk > kMaxGroup)
    return cudaErrorInvalidValue;
  const int* st = static_cast<const int*>(start);
  const int* ps = static_cast<const int*>(pos);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(Dh, q, k, v, k_new, v_new, st, ps, out, sc, B, H, Hk, S, scale, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(Dh, q, k, v, k_new, v_new, st, ps, out, sc, B, H, Hk, S, scale, s);
  return cudaErrorInvalidValue;
}
