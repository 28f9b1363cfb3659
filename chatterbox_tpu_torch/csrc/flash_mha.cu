// K2: bidirectional multi-head attention with a key-validity mask, for Hopper
// (sm_90a).
//
// Replaces chatterbox_tpu/ops/pallas_mha.py::flash_mha (kernel _mha_kernel),
// which carries every transformer block of every CFM estimator evaluation on
// the uncached S3Gen path and in the per-voice prompt prefill; in its context
// form (below) it also carries every cached and streaming evaluation, which
// the JAX package computes as a plain einsum. It computes softmax over the
// valid keys of q·kᵀ·scale with float32 accumulation, a row whose keys are all
// masked returning 0. Unlike the Pallas kernel it pads nothing outside: the
// ragged Tq and Tk edges are masked inside the kernel.
//
// What bounds it on the H100: operations. At the serving shapes (T ≈ 600-2,500
// frames, dh = 64) a (lane, head) does 4·T²·dh flops on 4·T·dh elements, far
// above the card's balance point, so the kernel has to run its products on the
// tensor cores. The design, after FlashAttention-2:
//   - one block per (query tile, head, lane): one warpgroup whose warps own 16
//     or 32 query rows each (one or two 16-row m-tiles; see m_tiles) and keep
//     their Q fragments, S/P tiles, output accumulators and online-softmax
//     state (max, sum) in registers;
//   - 64-key K and V tiles flow through a 2-stage shared-memory ring filled by
//     16-byte cp.async (zero-filled past T), so tile j+1 is in flight while
//     tile j computes; one barrier per tile (two in the float32 body);
//   - Q·Kᵀ and P·V run as mma.sync.m16n8k16 (bf16 in, f32 accumulate) with
//     operands from ldmatrix; P goes from the S accumulators to the A operand
//     of P·V in registers, never through shared memory. With two m-tiles each
//     K/V fragment read from shared memory feeds two products: shared-memory
//     reads, not the tensor cores, are what one m-tile per warp ran into;
//   - rows are padded by 16 bytes in shared memory, so ldmatrix is free of
//     bank conflicts; the key mask is read once per block into a bit mask in
//     shared memory, and exponentials are ex2.approx in the log2 domain;
//   - a key tile whose keys are all masked adds p = 0 exactly, so the block
//     lists the tiles holding a valid key and loads and computes only those
//     (a streaming call's empty ring, a batch's padded tail).
//
// Precision contract. The bfloat16 body multiplies bf16 inputs, rounds P to
// bf16 for P·V, and accumulates in f32. The float32 body ("bf16x3") splits
// every operand x into hi = bf16(x) and lo = bf16(x - hi) and forms each
// product as hi·hi + hi·lo + lo·hi with f32 accumulation (about 16 bits of
// mantissa per operand; the dropped lo·lo term is 2^-16 relative). K and V
// are split once per tile when the tile is staged, Q once per block, P per
// tile in registers. Emulated in float32 on the CPU at B = 32, H = 8,
// T = 628, dh = 64 (randn inputs), it stays within 9.0e-6 of the plain
// float32 version, under the 2e-5 the contract allows
// (tests/test_torch_flash_mha.py).
//
// Two forms share the kernel. The self form attends T queries over the same
// T keys (the per-voice prompt prefill, the uncached path). The context form
// attends Tq queries over Tk ≥ Tq keys: a cached or streaming estimator call
// prepends the frozen [prompt | ring] keys and values to its own, so its Tq
// new frames see Tk = prompt + ring + Tq keys with a key mask of their own.
// The grid runs over Tq tiles, the key loop over Tk.
//
// Layouts: q/out [B, H, Tq, dh], k/v [B, H, Tk, dh], all contiguous; valid
// [B, Tk] bool (one byte). Launches on the caller's stream, allocates
// nothing, does not synchronise; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 128;      // one warpgroup
constexpr int kPad = 8;            // bf16 padding per operand row (16 bytes)
constexpr float kNegInf = -1e9f;   // finite mask value, as the JAX package
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global → shared copy; src_bytes = 0 writes zeros (rows past T)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>   // until at most N groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d += a · b for a 16x16 bf16 A (row-major fragment) and a 16x8 bf16 B
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// Depth of the K/V ring: 3 for bf16; 2 for float32, whose raw f32 stages are
// twice the size (a third would cut the blocks per SM from two to one)
template <typename T>
__host__ __device__ constexpr int stages() { return std::is_same<T, float>::value ? 2 : 3; }

// Shared memory, in bytes. bfloat16 body: the ring holds the operand tiles
// themselves, [stages][K, V][kBK][DH + kPad] bf16. float32 body: the ring
// holds raw f32 tiles [stages][K, V][kBK][DH], split once per tile into
// operand tiles [K hi, K lo, V hi, V lo][kBK][DH + kPad] bf16. The key mask
// follows, one bit per key, then the list of live key tiles.
template <typename T, int DH>
__host__ __device__ constexpr size_t ring_bytes() {
  return std::is_same<T, float>::value ? size_t(stages<T>()) * 2 * kBK * DH * sizeof(float)
                                       : size_t(stages<T>()) * 2 * kBK * (DH + kPad) * 2;
}
template <typename T, int DH>
__host__ __device__ constexpr size_t smem_bytes() {
  return ring_bytes<T, DH>() +
         (std::is_same<T, float>::value ? size_t(4) * kBK * (DH + kPad) * 2 : 0);
}

// Query rows per warp, in 16-row m-tiles. Two m-tiles let every K/V fragment
// read from shared memory feed two products, which halves the shared-memory
// traffic per product. At dh = 128 the bodies keep one: two would spill.
template <typename T, int DH>
__host__ __device__ constexpr int m_tiles() { return DH > 64 ? 1 : 2; }
template <typename T, int DH>
__host__ __device__ constexpr int block_rows() { return 4 * 16 * m_tiles<T, DH>(); }

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_mha_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ valid, T* __restrict__ out, int H, int Tq,
                 int Tk, float scale) {
  static_assert(DH % 16 == 0, "head dim must be a multiple of 16");
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kMT = m_tiles<T, DH>();   // 16-row m-tiles per warp
  constexpr int kLd = DH + kPad;          // bf16 row stride of an operand tile
  constexpr int kKS = DH / 16;            // k-steps of Q·Kᵀ
  constexpr int kNS = kBK / 8;            // n-tiles of S (8 keys each)
  constexpr int kND = DH / 8;             // n-tiles of O (8 columns each)
  constexpr int kEl = 16 / sizeof(T);     // elements per 16-byte copy
  constexpr int kChunks = kBK * DH / kEl; // 16-byte copies per K (or V) tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  __nv_bfloat16* ops = reinterpret_cast<__nv_bfloat16*>(smem + ring_bytes<T, DH>());
  uint32_t* vbits = reinterpret_cast<uint32_t*>(smem + smem_bytes<T, DH>());  // key mask
  constexpr int kRaw = kSplit ? kBK * DH : kBK * kLd;   // elements per ring tile

  const int q0 = blockIdx.x * block_rows<T, DH>();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;    // fragment row (and B-fragment column)
  const int tig = lane & 3;    // thread in the quad
  const size_t q_base = (size_t(b) * H + h) * size_t(Tq) * DH;   // q and out
  const size_t k_base = (size_t(b) * H + h) * size_t(Tk) * DH;   // k and v
  const T* kh = k + k_base;
  const T* vh = v + k_base;

  // K and V rows [k0, k0 + kBK) → ring stage; rows past Tk arrive as zeros
  auto load_tile = [&](int k0, int stage) {
    T* ks = ring + (stage * 2) * kRaw;
    T* vs = ks + kRaw;
    for (int i = tid; i < kChunks; i += kThreads) {
      const int r = i / (DH / kEl), c = (i % (DH / kEl)) * kEl;
      const bool in = k0 + r < Tk;
      const size_t src = in ? size_t(k0 + r) * DH + c : 0;
      const int dst = kSplit ? r * DH + c : r * kLd + c;
      cp_async16(ks + dst, kh + src, in);
      cp_async16(vs + dst, vh + src, in);
    }
  };

  const int nt = (Tk + kBK - 1) / kBK;
  // the keys' validity as bits, one word per 32 keys (zero past Tk)
  for (int w = warp; w < 2 * nt; w += kThreads / 32) {
    const int t = w * 32 + lane;
    const unsigned word = __ballot_sync(0xffffffffu, t < Tk && valid[size_t(b) * Tk + t] != 0);
    if (lane == 0) vbits[w] = word;
  }
  __syncthreads();
  // live[0, n_live): the key tiles holding a valid key, in order
  int* live = reinterpret_cast<int*>(vbits + 2 * nt);
  if (warp == 0) {
    int n = 0;
    for (int t0 = 0; t0 < nt; t0 += 32) {
      const int t = t0 + lane;
      const bool any = t < nt && (vbits[2 * t] | vbits[2 * t + 1]) != 0;
      const unsigned m = __ballot_sync(0xffffffffu, any);
      if (any) live[n + __popc(m & ((1u << lane) - 1))] = t;
      n += __popc(m);
    }
    if (lane == 0) live[nt] = n;
  }
  __syncthreads();
  const int n_live = live[nt];

  constexpr int kStages = stages<T>();
  for (int st = 0; st < kStages - 1; ++st) {   // one commit group per tile
    if (st < n_live) load_tile(live[st] * kBK, st);
    cp_async_commit();
  }

  // Q fragments (A operand, 16 rows x 16 dims per k-step), once per block
  uint32_t qa[kMT][kKS][4], ql[kMT][kKS][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int ra = q0 + (warp * kMT + mt) * 16 + gr, rb = ra + 8;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const int c = ks * 16 + tig * 2;
      const int rows[4] = {ra, rb, ra, rb};
      const int cols[4] = {c, c, c + 8, c + 8};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = rows[i] < Tq;
        const size_t off = q_base + size_t(rows[i]) * DH + cols[i];
        if constexpr (kSplit) {
          const float2 x = in ? *reinterpret_cast<const float2*>(q + off) : make_float2(0.f, 0.f);
          split_bf16(x.x, x.y, qa[mt][ks][i], ql[mt][ks][i]);
        } else {
          qa[mt][ks][i] = in ? *reinterpret_cast<const uint32_t*>(q + off) : 0u;
          ql[mt][ks][i] = 0u;
        }
      }
    }
  }

  float o[kMT][kND][4];
  float m_i[kMT][2], l_i[kMT][2];   // running max (log2 domain) and this thread's sum
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    m_i[mt][0] = m_i[mt][1] = kNegInf;
    l_i[mt][0] = l_i[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < kND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
  }
  const float sl2 = scale * kLog2e;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: this lane's matrix and row

  for (int j = 0; j < n_live; ++j) {
    cp_async_wait<kStages - 2>();   // live tile j has landed
    __syncthreads();   // ... for every thread; tile j-1's stage and operands are free
    if (j + kStages - 1 < n_live)
      load_tile(live[j + kStages - 1] * kBK, (j + kStages - 1) % kStages);
    cp_async_commit();

    const __nv_bfloat16 *k_hi, *k_lo, *v_hi, *v_lo;
    if constexpr (kSplit) {
      // split the raw f32 tile into bf16 hi/lo operand tiles
      const float* raw = reinterpret_cast<const float*>(ring) + ((j % kStages) * 2) * kRaw;
      for (int i = tid; i < 2 * kChunks; i += kThreads) {
        const int which = i / kChunks, rem = i % kChunks;
        const int r = rem / (DH / 4), c = (rem % (DH / 4)) * 4;
        const float4 x = *reinterpret_cast<const float4*>(raw + which * kRaw + r * DH + c);
        uint2 hi, lo;
        split_bf16(x.x, x.y, hi.x, lo.x);
        split_bf16(x.z, x.w, hi.y, lo.y);
        __nv_bfloat16* dst = ops + (which * 2) * kBK * kLd + r * kLd + c;
        *reinterpret_cast<uint2*>(dst) = hi;
        *reinterpret_cast<uint2*>(dst + kBK * kLd) = lo;
      }
      __syncthreads();
      k_hi = ops;
      k_lo = ops + kBK * kLd;
      v_hi = ops + 2 * kBK * kLd;
      v_lo = ops + 3 * kBK * kLd;
    } else {
      k_hi = reinterpret_cast<const __nv_bfloat16*>(ring) + ((j % kStages) * 2) * kRaw;
      v_hi = k_hi + kRaw;
      k_lo = v_lo = nullptr;
    }

    // S = Q·Kᵀ: ldmatrix.x4 gives the B fragments of two 8-key n-tiles
    float s[kMT][kNS][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int np = 0; np < kNS / 2; ++np) {
        const int off = (np * 16 + (mi >> 1) * 8 + mr) * kLd + ks * 16 + (mi & 1) * 8;
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, k_hi + off);
        if constexpr (kSplit) ldsm_x4(bl, k_lo + off);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][2 * np], qa[mt][ks], bh[0], bh[1]);
          mma_bf16(s[mt][2 * np + 1], qa[mt][ks], bh[2], bh[3]);
          if constexpr (kSplit) {
            mma_bf16(s[mt][2 * np], qa[mt][ks], bl[0], bl[1]);
            mma_bf16(s[mt][2 * np + 1], qa[mt][ks], bl[2], bl[3]);
            mma_bf16(s[mt][2 * np], ql[mt][ks], bh[0], bh[1]);
            mma_bf16(s[mt][2 * np + 1], ql[mt][ks], bh[2], bh[3]);
          }
        }
      }
    }

    // online softmax in the log2 domain; masked keys get p = 0 exactly (a
    // tile whose keys are all masked would otherwise give exp(0) = 1)
    const int kt = live[j];
    const uint32_t w0 = vbits[2 * kt] >> (tig * 2), w1 = vbits[2 * kt + 1] >> (tig * 2);
    auto key_ok = [&](int n, int e) {   // key kt*kBK + n*8 + tig*2 + e
      return (((n < 4 ? w0 : w1) >> ((n & 3) * 8 + e)) & 1u) != 0;
    };
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][n][e] = key_ok(n, e & 1) ? s[mt][n][e] * sl2 : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][n][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_i[mt][r], mx[r]);
        alpha[r] = fast_exp2(m_i[mt][r] - m_new);
        m_i[mt][r] = m_new;
        l_i[mt][r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = key_ok(n, e & 1) ? fast_exp2(s[mt][n][e] - m_i[mt][e >> 1]) : 0.f;
          s[mt][n][e] = p;
          l_i[mt][e >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        o[mt][n][0] *= alpha[0];
        o[mt][n][1] *= alpha[0];
        o[mt][n][2] *= alpha[1];
        o[mt][n][3] *= alpha[1];
      }
    }

    // O += P·V: the S accumulators of key n-tiles 2kk, 2kk+1 are the A
    // fragment of k-step kk; ldmatrix.trans gives V's B fragments
#pragma unroll
    for (int kk = 0; kk < kNS / 2; ++kk) {
      uint32_t pa[kMT][4], pl[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {   // A registers: (row gr | gr+8) x (keys 0-7 | 8-15)
          const float x0 = s[mt][2 * kk + (i >> 1)][(i & 1) * 2];
          const float x1 = s[mt][2 * kk + (i >> 1)][(i & 1) * 2 + 1];
          if constexpr (kSplit) {
            split_bf16(x0, x1, pa[mt][i], pl[mt][i]);
          } else {
            pa[mt][i] = pack_bf16(x0, x1);
          }
        }
#pragma unroll
      for (int np = 0; np < kND / 2; ++np) {
        const int off = (kk * 16 + (mi & 1) * 8 + mr) * kLd + np * 16 + (mi >> 1) * 8;
        uint32_t bh[4], bl[4];
        ldsm_x4_trans(bh, v_hi + off);
        if constexpr (kSplit) ldsm_x4_trans(bl, v_lo + off);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(o[mt][2 * np], pa[mt], bh[0], bh[1]);
          mma_bf16(o[mt][2 * np + 1], pa[mt], bh[2], bh[3]);
          if constexpr (kSplit) {
            mma_bf16(o[mt][2 * np], pa[mt], bl[0], bl[1]);
            mma_bf16(o[mt][2 * np + 1], pa[mt], bl[2], bl[3]);
            mma_bf16(o[mt][2 * np], pl[mt], bh[0], bh[1]);
            mma_bf16(o[mt][2 * np + 1], pl[mt], bh[2], bh[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // the quad holds a row's 64 columns of P: sum the partial row sums
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int t = q0 + (warp * kMT + mt) * 16 + gr + 8 * r;
      if (t >= Tq) continue;
      const float inv = 1.f / fmaxf(l, 1e-30f);
      T* dst = out + q_base + size_t(t) * DH + tig * 2;
#pragma unroll
      for (int n = 0; n < kND; ++n)
        store2(dst + n * 8, o[mt][n][2 * r] * inv, o[mt][n][2 * r + 1] * inv);
    }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out,
           int B, int H, int Tq, int Tk, float scale, cudaStream_t stream) {
  auto kernel = flash_mha_kernel<T, DH>;
  const int nt = (Tk + kBK - 1) / kBK;
  // + the key mask (2 words per tile) and the live-tile list (nt + 1 ints)
  const size_t bytes = smem_bytes<T, DH>() + size_t(3 * nt + 1) * sizeof(uint32_t);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Tq + block_rows<T, DH>() - 1) / block_rows<T, DH>(), H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), static_cast<T*>(out), H, Tq, Tk, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch_dh(int Dh, const void* q, const void* k, const void* v, const void* valid,
                void* out, int B, int H, int Tq, int Tk, float scale, cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch<T, 32>(q, k, v, valid, out, B, H, Tq, Tk, scale, stream);
    case 64: return launch<T, 64>(q, k, v, valid, out, B, H, Tq, Tk, scale, stream);
    case 128: return launch<T, 128>(q, k, v, valid, out, B, H, Tq, Tk, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16
extern "C" int flash_mha_launch(const void* q, const void* k, const void* v,
                                const void* valid, void* out, int B, int H, int Tq,
                                int Tk, int Dh, int dtype, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dh<float>(Dh, q, k, v, valid, out, B, H, Tq, Tk, scale, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(Dh, q, k, v, valid, out, B, H, Tq, Tk, scale, s);
  return cudaErrorInvalidValue;
}
