// K2's context form, for Hopper (sm_90a): Tq new frames of a cached or
// streaming CFM estimator call attend over three key segments read where
// they lie, [prompt | ring | own], with a key-validity mask.
//
// Replaces the context form of csrc/flash_mha.cu, which read one float32
// [prompt | ring | own] buffer that the caller copied together for every
// solve. The TPU kernel behind K2 is chatterbox_tpu/ops/pallas_mha.py
// (flash_mha, body _mha_kernel); the JAX package computes this form as the
// einsum of chatterbox_tpu/models/s3gen_ref/decoder.py:280-298. Semantics:
// softmax(q·kᵀ·scale) over the valid keys, float32 sums; a row whose keys
// are all masked returns 0.
//
// Layouts (all contiguous): q, k_own, v_own, out [B2, H, Tq, 64] in the
// activation dtype; k_prompt, v_prompt [Bp, H, P, 64] and k_ring, v_ring
// [B2, H, W, 64] in the weights' dtype (W = 0: no ring). Bp is B2, or 2 for
// a voice captured at batch 1: lane b then reads prompt row b / (B2 / 2), the
// [cond × B, uncond × B] lane layout. valid [B2, P + W + Tq] bool (a byte).
// Dtype pairs (q, context): (f32, bf16), the serving default; (f32, f32);
// (bf16, bf16).
//
// What bounds it on the H100: bytes, in principle. A streaming call (32
// lanes, H = 8, Tq = 72-202 over 500 prompt and up to 512 ring keys) does
// 4·Tq·dh flops per key it reads, under the card's balance point, so the
// least time is its bytes: the bf16 context keys and values, the f32
// queries, own keys and values and the output. The design, after
// FlashAttention-3:
//   - one block per (query tile of 128 rows, head, lane): a producer
//     warpgroup and two consumer warpgroups of 64 query rows each; setmaxnreg
//     moves registers from the producer to the consumers. A consumer
//     warpgroup with no valid row leaves at once (Tq = 142 and 202 run 3 and
//     4 of the 4 warpgroups of their two blocks); a warp whose rows all lie
//     past Tq skips the softmax;
//   - the producer fills a 4-stage ring of K/V operand tiles (64 keys each)
//     with 16-byte cp.async straight into wgmma's 128-byte-swizzled layout,
//     rows past a segment's end zero-filled, and signals each stage through
//     a "full" mbarrier (cp.async.mbarrier.arrive.noinc); the consumers free
//     a stage through its "empty" mbarrier. Only the key tiles holding a
//     valid key are listed, loaded and computed (a lane with an empty ring
//     reads its prompt and own tiles only);
//   - bf16 tiles go from HBM into the operand layout as they are: no split
//     pass, half the bytes of the float32 buffer. A float32 tile (the own
//     segment under float32 activations, every tile under float32 weights)
//     lands raw in one of two staging buffers, the first two from the start
//     of the block; the producer warpgroup splits it into bf16 hi and lo
//     operand tiles in shared memory when its turn in the ring comes;
//   - the consumers run S = Q·Kᵀ and O += P·V as wgmma.m64n64k16 with A (Q,
//     then P) from registers and B (K; V, transposed) from shared memory,
//     P going from the S accumulators to the A fragments in registers. The
//     two consumer warpgroups take turns at the tensor cores (ping-pong,
//     named barriers): a turn issues S_j and PV_{j-1}, and the warpgroup
//     runs tile j's softmax while the other one's turn runs.
// What sets its time on the card (chip_smoke.py phase 3, PERF.md): the
// consumers, not the copies. Per key tile a block issues 2 x 16 wgmma in
// float32 (the bf16x3 products double the bf16 count), and at Tq = 72, 56
// of the second warpgroup's 64 rows are padding (wgmma's M is 64); each
// warpgroup's softmax (32 exponentials per thread and tile) overlaps the
// other's turn only in part. Two ptxas rules keep the wgmma batches
// asynchronous: every branch around them is on a value ptxas can prove
// warp-uniform (warp_uniform), and no other instruction touches an
// accumulator between issue and wait.
//
// Precision contract (bf16x3, as csrc/flash_mha.cu): a float32 operand x
// is split into hi = bf16(x) and lo = bf16(x - hi), and each product is
// hi·hi + hi·lo + lo·hi with float32 sums. A bf16 context key has lo = 0,
// so S = Q_hi·K + Q_lo·K and O += P_hi·V + P_lo·V on bf16 tiles: the two
// products the earlier design added as exact zeros are not issued. Own
// (float32) tiles take all three. The bf16 pair takes one product each, P
// rounded to bf16. Emulated on the CPU at the streaming shapes it stays
// within 2e-5 of the plain float32 version (tests/test_torch_flash_mha.py).
//
// Launches on the caller's stream, allocates nothing, does not synchronise;
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kDH = 64;                          // head dim (the estimator's)
constexpr int kBK = 64;                          // keys per tile
constexpr int kConsumers = 2;                    // consumer warpgroups per block
constexpr int kThreads = 128 * (1 + kConsumers); // + the producer warpgroup
constexpr int kBlockRows = 64 * kConsumers;      // query rows per block
constexpr int kStages = 4;                       // operand ring depth
constexpr int kRawBufs = 2;                      // float32 staging buffers
constexpr int kOpTile = kBK * kDH * 2;           // bytes of a bf16 operand tile
constexpr int kRawTile = kBK * kDH * 4;          // bytes of a raw float32 tile
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 216;   // 128 x 56 + 256 x 216 <= 384 x 168 at launch
constexpr float kInf = __builtin_huge_valf();
constexpr float kLog2e = 1.4426950408889634f;

// the supported (q, context) dtype pairs
template <int PAIR> struct Types;
template <> struct Types<0> { using Q = float; using C = bf16; };
template <> struct Types<1> { using Q = float; using C = float; };
template <> struct Types<2> { using Q = bf16; using C = bf16; };

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle repeats
// every 8 rows): the ring's stages, each [K hi | V hi | K lo | V lo] operand
// tiles (the lo half only where a float32 tile can occur), then the raw
// float32 staging buffers [K | V], then the mbarriers full[kStages],
// empty[kStages], raw[kRawBufs], then per key tile its mask (two words)
// and the live-tile list.
template <int PAIR>
struct Smem {
  using Q = typename Types<PAIR>::Q;
  using C = typename Types<PAIR>::C;
  static constexpr bool kQSplit = std::is_same<Q, float>::value;    // Q, P and own tiles split
  static constexpr bool kCtxSplit = std::is_same<C, float>::value;  // prompt and ring tiles split
  static constexpr int kStage = (kQSplit ? 4 : 2) * kOpTile;
  static constexpr int kRaw = kStages * kStage;
  static constexpr int kBars = kRaw + (kQSplit ? kRawBufs * 2 * kRawTile : 0);
  static constexpr int kFixed = kBars + (2 * kStages + kRawBufs) * 8;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// x as lane 0 holds it: a value ptxas knows to be the same across the warp.
// Every branch around or between wgmma batches is taken on such values;
// on a value it cannot prove warp-uniform (threadIdx, a shared-memory load)
// ptxas serializes every wgmma of the kernel (C7518).
__device__ __forceinline__ int warp_uniform(int x) { return __shfl_sync(0xffffffffu, x, 0); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait until the phase of parity `parity` has completed; a wait of more than
// about ten seconds is a broken pipeline, and traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// ---- copies ----
// 16-byte global → shared copy; `in` false writes zeros (rows past a segment)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}
// one arrival on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// generic-proxy shared memory accesses before it are ordered with the async
// proxy (wgmma's operand reads) after it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// ---- wgmma ----
// Descriptor of a 128-byte-swizzled bf16 operand tile at shared address
// `addr` (1024-byte aligned, plus a k-step's offset): 8-row groups 1024
// bytes apart (SBO). K tiles are K-major (LBO unused); V tiles are read
// transposed (MN-major), one 64-column swizzle atom wide, so LBO, the
// stride between atoms, is never stepped: both offsets are set to 1024.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// keep the compiler from moving accesses of registers that an in-flight
// wgmma reads or writes across the fence/commit/wait instructions
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d[64 x 64] += a[64 x 16] · b[16 x 64]: a from registers (this thread's
// m16n8k16-style fragment of its warp's 16 rows), b from shared memory;
// TRANS_B = 1 reads b MN-major (V), 0 K-major (K)
template <int TRANS_B, int SCALE_D>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(SCALE_D), "n"(TRANS_B));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// One batch of products into d, issued and committed (not waited for): the
// k-steps of a_hi·B, then (LO) of a_lo·B, then (SPLIT) of a_hi·B_lo; FRESH
// overwrites d (the first product ignores d's old value). B is a K tile
// (TRANS_B = 0; a k-step is 16 columns, 32 bytes) or a V tile (TRANS_B = 1; a
// k-step is 16 rows, 2048 bytes). Straight-line for each variant, so ptxas
// sees one unbranched wgmma sequence.
template <int TRANS_B, bool LO, bool SPLIT, bool FRESH>
__device__ __forceinline__ void issue(float (&d)[32], const uint32_t (&a_hi)[4][4],
                                      const uint32_t (&a_lo)[4][4], uint64_t b_hi, uint64_t b_lo) {
  constexpr uint64_t kStep = TRANS_B ? 2048 >> 4 : 32 >> 4;   // descriptor units of 16 bytes
  wgmma_fence();
  wgmma_rs<TRANS_B, FRESH ? 0 : 1>(d, a_hi[0], b_hi);
#pragma unroll
  for (int k = 1; k < 4; ++k) wgmma_rs<TRANS_B, 1>(d, a_hi[k], b_hi + k * kStep);
  if constexpr (LO) {
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_rs<TRANS_B, 1>(d, a_lo[k], b_hi + k * kStep);
  }
  if constexpr (SPLIT) {
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_rs<TRANS_B, 1>(d, a_hi[k], b_lo + k * kStep);
  }
  wgmma_commit();
}

// ---- numbers ----
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x0, x1) → bf16x2 with x0 in the low half (the lower matrix index)
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  return bits(__floats2bfloat162_rn(x0, x1));
}
// the bf16x3 split of (x0, x1): hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

struct Args {
  const void *q, *k_own, *v_own, *k_prompt, *v_prompt, *k_ring, *v_ring;
  const uint8_t* valid;
  void* out;
  int B2, Bp, H, Tq, P, W;
  float scale;
};

// key tile t of the block's list → its segment (0 prompt, 1 ring, 2 own),
// first key within the segment, the segment's length and its first column
// in the key mask
struct Seg {
  int kind, k0, len, off;
};
__device__ __forceinline__ Seg segment(int t, int nP, int nW, const Args& a) {
  if (t < nP) return {0, t * kBK, a.P, 0};
  if (t < nP + nW) return {1, (t - nP) * kBK, a.W, a.P};
  return {2, (t - nP - nW) * kBK, a.Tq, a.P + a.W};
}

template <int PAIR>
__global__ void __launch_bounds__(kThreads, 1) flash_ctx_kernel(const Args a) {
  using L = Smem<PAIR>;
  using TQ = typename L::Q;
  using TC = typename L::C;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full = sbase + L::kBars;            // mbarrier addresses, 8 bytes apart
  const uint32_t empty = full + 8 * kStages;
  const uint32_t rawbar = empty + 8 * kStages;
  uint32_t* vbits = reinterpret_cast<uint32_t*>(smem + L::kFixed);

  const int q0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int nP = cdiv(a.P, kBK), nW = cdiv(a.W, kBK), nt = nP + nW + cdiv(a.Tq, kBK);
  int* live = reinterpret_cast<int*>(vbits + 2 * nt);
  const int n_keys = a.P + a.W + a.Tq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int live_wgs = min(kConsumers, cdiv(a.Tq - q0, 64));   // consumers with a valid row

  if (tid >= 128) {   // the consumers' query rows (128-byte lines), on their way to L2
    constexpr int kLines = kDH * sizeof(TQ) / 128;
    const int row = q0 + (tid - 128) / kLines, line = (tid - 128) % kLines;
    if (row < min(a.Tq, q0 + kBlockRows))
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(static_cast<const unsigned char*>(a.q) +
                   ((size_t(b) * a.H + h) * a.Tq + row) * kDH * sizeof(TQ) + line * 128));
  }
  // the keys' validity as bits, two words per tile (zero past a segment's
  // end); each warp loads its (up to) four words' bytes before any ballot
  constexpr int kWarps = kThreads / 32;
  for (int w0 = warp; w0 < 2 * nt; w0 += 4 * kWarps) {
    bool ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = w0 + u * kWarps;
      const Seg sg = segment(w >> 1, nP, nW, a);
      const int key = sg.k0 + (w & 1) * 32 + lane;
      ok[u] = w < 2 * nt && key < sg.len && a.valid[size_t(b) * n_keys + sg.off + key] != 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned word = __ballot_sync(0xffffffffu, ok[u]);
      if (lane == 0 && w0 + u * kWarps < 2 * nt) vbits[w0 + u * kWarps] = word;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 128);          // one arrival per producer thread
      mbar_init(empty + 8 * s, live_wgs);    // one per live consumer warpgroup
    }
    for (int r = 0; r < kRawBufs; ++r) mbar_init(rawbar + 8 * r, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // live[0, n_live): the key tiles holding a valid key, in order; the
  // first n_ctx of them are prompt and ring tiles, the rest own tiles
  if (warp == 0) {
    int n = 0, n_ctx = 0;
    for (int t0 = 0; t0 < nt; t0 += 32) {
      const int t = t0 + lane;
      const bool any = t < nt && (vbits[2 * t] | vbits[2 * t + 1]) != 0;
      const unsigned m = __ballot_sync(0xffffffffu, any);
      if (any) live[n + __popc(m & ((1u << lane) - 1))] = t;
      n += __popc(m);
      n_ctx += __popc(__ballot_sync(0xffffffffu, any && t < nP + nW));
    }
    if (lane == 0) {
      live[nt] = n;
      live[nt + 1] = n_ctx;
    }
  }
  __syncthreads();
  const int n_live = live[nt];

  if (tid < 128) {
    // ================= producer warpgroup =================
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    // segment sg's K (which = 0) or V (1) rows of this (lane, head)
    auto rows = [&](const Seg& sg, int which) -> const unsigned char* {
      if (sg.kind == 2) {
        return static_cast<const unsigned char*>(which ? a.v_own : a.k_own) +
               (size_t(b) * a.H + h) * a.Tq * kDH * sizeof(TQ);
      }
      const int lane_row = sg.kind == 1 || a.Bp == a.B2 ? b : b / (a.B2 / 2);   // Bp = 2
      const void* base = sg.kind == 1 ? (which ? a.v_ring : a.k_ring)
                                      : (which ? a.v_prompt : a.k_prompt);
      return static_cast<const unsigned char*>(base) +
             (size_t(lane_row) * a.H + h) * (sg.kind == 1 ? a.W : a.P) * kDH * sizeof(TC);
    };

    // The float32 tiles (own tiles, or every tile under float32 weights)
    // are the list's suffix [first_f, n_live). Their raw copies run up to
    // kRawBufs tiles ahead of their split, the first ones from the start, so
    // the own tiles at the end of the list find their data staged.
    const int first_f = !L::kQSplit ? n_live : L::kCtxSplit ? 0 : live[nt + 1];
    const int n_f = n_live - first_f;
    auto issue_raw = [&](int k) {   // float32 tile k (list index first_f + k) → buffer k % 2
      const Seg sg = segment(live[first_f + k], nP, nW, a);
      const unsigned char* ks = rows(sg, 0);
      const unsigned char* vs = rows(sg, 1);
      const uint32_t raw = sbase + L::kRaw + (k % kRawBufs) * 2 * kRawTile;
      for (int i = tid; i < kBK * 16; i += 128) {
        const int row = i >> 4, c = i & 15;
        const bool in = sg.k0 + row < sg.len;
        const size_t src = in ? size_t(sg.k0 + row) * 256 + c * 16 : 0;
        cp_async16(raw + row * 256 + c * 16, ks + src, in);
        cp_async16(raw + kRawTile + row * 256 + c * 16, vs + src, in);
      }
      cp_async_arrive(rawbar + 8 * (k % kRawBufs));
    };
    if constexpr (L::kQSplit) {
      for (int k = 0; k < min(kRawBufs, n_f); ++k) issue_raw(k);
    }

    for (int j = 0; j < n_live; ++j) {
      const int s = j % kStages;
      const uint32_t stage = sbase + s * L::kStage;
      mbar_wait(empty + 8 * s, ((j / kStages) & 1) ^ 1);
      if (L::kQSplit && j >= first_f) {
        // split the staged float32 tile into bf16 hi/lo operand tiles
        const int k = j - first_f, r = k % kRawBufs;
        mbar_wait(rawbar + 8 * r, (k / kRawBufs) & 1);
        const unsigned char* raw = smem + L::kRaw + r * 2 * kRawTile;
        for (int i = tid; i < 2 * kBK * 8; i += 128) {   // (K | V, row, 8-value group)
          const int which = i >> 9, row = (i >> 3) & (kBK - 1), g = i & 7;
          const float4* src =
              reinterpret_cast<const float4*>(raw + which * kRawTile + row * 256 + g * 32);
          const float4 x0 = src[0], x1 = src[1];
          uint4 hi, lo;
          split_bf16(x0.x, x0.y, hi.x, lo.x);
          split_bf16(x0.z, x0.w, hi.y, lo.y);
          split_bf16(x1.x, x1.y, hi.z, lo.z);
          split_bf16(x1.z, x1.w, hi.w, lo.w);
          const int off = swz(row, g);
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                       ::"r"(stage + which * kOpTile + off), "r"(hi.x), "r"(hi.y), "r"(hi.z),
                         "r"(hi.w)
                       : "memory");
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                       ::"r"(stage + (2 + which) * kOpTile + off), "r"(lo.x), "r"(lo.y),
                         "r"(lo.z), "r"(lo.w)
                       : "memory");
        }
        fence_proxy_async();
        mbar_arrive(full + 8 * s);
        // every thread has read buffer r before a copy refills it
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        if (k + kRawBufs < n_f) issue_raw(k + kRawBufs);
      } else {
        // bf16 rows [k0, k0 + 64) of K and V → the stage's hi operand tiles
        const Seg sg = segment(live[j], nP, nW, a);
        const unsigned char* ks = rows(sg, 0);
        const unsigned char* vs = rows(sg, 1);
        for (int i = tid; i < kBK * 8; i += 128) {
          const int row = i >> 3, c = i & 7;
          const bool in = sg.k0 + row < sg.len;
          const size_t src = in ? size_t(sg.k0 + row) * 128 + c * 16 : 0;
          cp_async16(stage + swz(row, c), ks + src, in);
          cp_async16(stage + kOpTile + swz(row, c), vs + src, in);
        }
        cp_async_arrive(full + 8 * s);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");   // no copy outlives its thread
  } else {
    // ================= consumer warpgroups =================
    const int cw = warp_uniform(tid >> 7) - 1;
    if (cw >= live_wgs) return;   // all 64 rows past Tq
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int ct = tid & 127, w4 = warp_uniform(ct >> 5);
    const int n_tiles = warp_uniform(n_live);
    const int gr = lane >> 2, tig = lane & 3;
    const int ra = q0 + cw * 64 + w4 * 16 + gr, rb = ra + 8;   // this thread's two rows
    const size_t q_base = (size_t(b) * a.H + h) * size_t(a.Tq) * kDH;
    const TQ* q = static_cast<const TQ*>(a.q) + q_base;

    // Q fragments (A operand, 16 rows x 16 dims per k-step), hi and lo
    uint32_t qh[4][4], ql[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int c = ks * 16 + tig * 2;
      const int rows[4] = {ra, rb, ra, rb};
      const int cols[4] = {c, c, c + 8, c + 8};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = rows[i] < a.Tq;
        const size_t off = size_t(rows[i]) * kDH + cols[i];
        if constexpr (L::kQSplit) {
          const float2 x = in ? *reinterpret_cast<const float2*>(q + off) : make_float2(0.f, 0.f);
          split_bf16(x.x, x.y, qh[ks][i], ql[ks][i]);
        } else {
          qh[ks][i] = in ? *reinterpret_cast<const uint32_t*>(q + off) : 0u;
          ql[ks][i] = 0u;
        }
      }
    }

    float o[32], sc[32];           // output; S, then P, of the current tile
    uint32_t ph[4][4], pl[4][4];   // P's A fragments (hi, lo) for the next PV batch
    float m_i[2] = {-kInf, -kInf}, l_i[2] = {0.f, 0.f};   // row max (log2 domain), sum
    float alpha[2] = {1.f, 1.f};   // O's rescale before the next PV batch
    const float sl2 = a.scale * kLog2e;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) ph[kk][i] = pl[kk][i] = 0u;
    // A warp whose 16 rows all lie past Tq skips the softmax (its P stays
    // 0); one whose last 8 do takes its first 8 only. At Tq = 72 that is 7/8
    // of the second warpgroup's exponentials.
    const int wrow = q0 + cw * 64 + w4 * 16;
    const bool warp_dead = wrow >= a.Tq, half_dead = wrow + 8 >= a.Tq;

    // the tile's split-ness: own tiles under float32 q, every tile under
    // float32 weights
    auto split_tile = [&](int j) {
      return L::kQSplit && (L::kCtxSplit || warp_uniform(live[j]) >= nP + nW);
    };
    // S = Q·Kᵀ of list entry j, issued: Q_hi·K, + Q_lo·K (float32 Q),
    // + Q_hi·K_lo (a split tile)
    auto issue_s = [&](int j) {
      const uint32_t stage = sbase + (j % kStages) * L::kStage;
      if (split_tile(j)) {
        issue<0, L::kQSplit, true, true>(sc, qh, ql, desc_sw128(stage),
                                         desc_sw128(stage + 2 * kOpTile));
      } else {
        issue<0, L::kQSplit, false, true>(sc, qh, ql, desc_sw128(stage), 0);
      }
    };
    // O += P·V of list entry j, issued: P_hi·V, + P_lo·V (float32),
    // + P_hi·V_lo (a split tile)
    auto issue_pv = [&](int j) {
      const uint32_t stage = sbase + (j % kStages) * L::kStage;
      const uint64_t dv = desc_sw128(stage + kOpTile);
      if (split_tile(j)) {
        issue<1, L::kQSplit, true, false>(o, ph, pl, dv, desc_sw128(stage + 3 * kOpTile));
      } else {
        issue<1, L::kQSplit, false, false>(o, ph, pl, dv, 0);
      }
    };
    // online softmax of S (list entry j, in sc) over its rows r < R: P in
    // sc, alpha for the next rescale. Masked keys are -inf, so p =
    // exp2(-inf) = 0 exactly; a live tile holds a valid key, so every row's
    // max is finite.
    auto softmax_rows = [&](int j, auto rows) {
      constexpr int R = decltype(rows)::value;
      const int t = live[j];
      const uint32_t v0 = vbits[2 * t], v1 = vbits[2 * t + 1];
      const bool full_tile = warp_uniform((v0 & v1) == 0xffffffffu);
      if (!full_tile) {
        const uint32_t w0 = v0 >> (tig * 2), w1 = v1 >> (tig * 2);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2 * R; ++e)   // key n*8 + tig*2 + (e & 1) of the tile
            sc[4 * n + e] = (((n < 4 ? w0 : w1) >> ((n & 3) * 8 + (e & 1))) & 1u) ? sc[4 * n + e] : -kInf;
      }
      // the row maxima and sums as trees over the thread's 16 values per row,
      // so the warp has independent work while the exponentials run
      float mx[2], neg_m[2], sum[2];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float t8[8];
#pragma unroll
        for (int n = 0; n < 8; ++n) t8[n] = fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]);
#pragma unroll
        for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
          for (int n = 0; n < w; ++n) t8[n] = fmaxf(t8[n], t8[n + w]);
        mx[r] = fmaxf(t8[0], __shfl_xor_sync(0xffffffffu, t8[0], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_i[r], mx[r] * sl2);
        alpha[r] = fast_exp2(m_i[r] - m_new);
        m_i[r] = m_new;
        neg_m[r] = -m_new;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = sc[4 * n + e];
          x = e < 2 * R ? fast_exp2(fmaf(x, sl2, neg_m[e >> 1])) : 0.f;   // rows past Tq: P = 0
        }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float t8[8];
#pragma unroll
        for (int n = 0; n < 8; ++n) t8[n] = sc[4 * n + 2 * r] + sc[4 * n + 2 * r + 1];
#pragma unroll
        for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
          for (int n = 0; n < w; ++n) t8[n] += t8[n + w];
        sum[r] = t8[0];
        l_i[r] = l_i[r] * alpha[r] + sum[r];
      }
    };
    // O *= alpha (no PV batch in flight), and P (sc) → the A fragments of
    // P·V: key n-tiles 2kk, 2kk+1 form k-step kk
    auto to_fragments = [&]() {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {   // (row gr | gr+8) x (keys 0-7 | 8-15)
          const float x0 = sc[4 * (2 * kk + (i >> 1)) + (i & 1) * 2];
          const float x1 = sc[4 * (2 * kk + (i >> 1)) + (i & 1) * 2 + 1];
          if constexpr (L::kQSplit) {
            split_bf16(x0, x1, ph[kk][i], pl[kk][i]);
          } else {
            ph[kk][i] = pack_bf16(x0, x1);
          }
        }
    };
    auto softmax = [&](int j) {
      if (warp_dead) return;
      if (half_dead) {
        softmax_rows(j, std::integral_constant<int, 1>{});
      } else {
        softmax_rows(j, std::integral_constant<int, 2>{});
      }
    };

    // Ping-pong (FA3): the two consumer warpgroups take turns at the tensor
    // cores, named barriers 2 + cw ordering the turns. Turn j issues S_j and
    // PV_{j-1}; the warpgroup then runs tile j's softmax while the other
    // one's turn runs. Turn 0 (S_0) and turn n_live (PV_last) complete the
    // n_live + 1 turns; warpgroup 0 takes the first turn without waiting,
    // and warpgroup 1 skips its last hand-over, so every barrier completes.
    const bool pingpong = live_wgs == 2;
    auto turn_begin = [&](int j) {
      if (pingpong && (cw == 1 || j > 0))
        asm volatile("bar.sync %0, 256;\n" ::"r"(2 + cw) : "memory");
    };
    auto turn_end = [&](int j) {
      if (pingpong && !(cw == 1 && j == n_tiles))
        asm volatile("bar.arrive %0, 256;\n" ::"r"(3 - cw) : "memory");
    };
    // Turn j issues S_j and PV_{j-1}. The first and the last turn are peeled
    // off, so the loop body waits for fixed group counts: ptxas keeps the
    // wgmma batches asynchronous only where no other instruction touches
    // their accumulators between issue and wait.
    auto wait_full = [&](int j) {
      mbar_wait(full + 8 * (j % kStages), (j / kStages) & 1);
      fence_proxy_async();   // the producer's cp.async and st.shared writes → wgmma's reads
    };
    auto finish_tile = [&](int j) {   // after S_j has landed in sc and PV_{j-1} is done
      if (!warp_dead) to_fragments();
      if (j > 0 && ct == 0) mbar_arrive(empty + 8 * ((j - 1) % kStages));
    };
    if (n_tiles > 0) {
      wait_full(0);
      turn_begin(0);
      issue_s(0);
      turn_end(0);
      wgmma_wait<0>();
      reg_fence(sc);
      softmax(0);
      finish_tile(0);
    }
    for (int j = 1; j < n_tiles; ++j) {
      wait_full(j);
      turn_begin(j);
      issue_s(j);
      issue_pv(j - 1);
      turn_end(j);
      wgmma_wait<1>();   // S_j (PV_{j-1} may still run)
      reg_fence(sc);
      softmax(j);
      wgmma_wait<0>();   // PV_{j-1}: its stage is free; P_j may replace its fragments
      reg_fence(o);
      reg_fence(ph);
      reg_fence(pl);
      finish_tile(j);
    }
    if (n_tiles > 0) {
      turn_begin(n_tiles);
      issue_pv(n_tiles - 1);
      turn_end(n_tiles);
      wgmma_wait<0>();
      reg_fence(o);
      if (ct == 0) mbar_arrive(empty + 8 * ((n_tiles - 1) % kStages));
    }

    // the quad holds a row's 64 columns of P: sum the partial row sums
    TQ* out = static_cast<TQ*>(a.out) + q_base;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = r ? rb : ra;
      if (row >= a.Tq) continue;
      const float inv = 1.f / fmaxf(l, 1e-30f);
      TQ* dst = out + size_t(row) * kDH + tig * 2;
#pragma unroll
      for (int n = 0; n < 8; ++n) store2(dst + n * 8, o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
  }
}

template <int PAIR>
int launch(const Args& a, cudaStream_t stream) {
  using L = Smem<PAIR>;
  auto kernel = flash_ctx_kernel<PAIR>;
  const int nt = cdiv(a.P, kBK) + cdiv(a.W, kBK) + cdiv(a.Tq, kBK);
  // + the alignment slack, the key mask (2 words per tile) and the live list
  // with its two counts
  const size_t bytes = 1024 + L::kFixed + size_t(3 * nt + 2) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid(cdiv(a.Tq, kBlockRows), a.H, a.B2);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. (q_dtype, ctx_dtype) must be
// (0, 1), (0, 0) or (1, 1); Dh must be 64; Bp must be B2, or 2 with B2 even.
extern "C" int flash_mha_context_launch(const void* q, const void* k_own, const void* v_own,
                                        const void* k_prompt, const void* v_prompt,
                                        const void* k_ring, const void* v_ring,
                                        const void* valid, void* out, int B2, int Bp, int H,
                                        int Tq, int P, int W, int Dh, int q_dtype,
                                        int ctx_dtype, float scale, void* stream) {
  if (B2 <= 0 || H <= 0 || Tq <= 0 || P < 0 || W < 0 || Dh != kDH) return cudaErrorInvalidValue;
  if (!(Bp == B2 || (Bp == 2 && B2 % 2 == 0))) return cudaErrorInvalidValue;
  const Args a{q, k_own, v_own, k_prompt, v_prompt, k_ring, v_ring,
               static_cast<const uint8_t*>(valid), out, B2, Bp, H, Tq, P, W, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && ctx_dtype == 1) return launch<0>(a, s);
  if (q_dtype == 0 && ctx_dtype == 0) return launch<1>(a, s);
  if (q_dtype == 1 && ctx_dtype == 1) return launch<2>(a, s);
  return cudaErrorInvalidValue;
}

