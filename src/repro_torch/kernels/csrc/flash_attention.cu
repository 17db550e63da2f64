// Flash-attention forward for Hopper (sm_90a), bound to PyTorch by ctypes.
//
// Replaces repro/kernels/flash_attention.py flash_attention (the Pallas
// kernel at :63, its body _kernel at :21), the prefill attention.  Given
// q (B, H, S, D) and k, v (B, Hkv, T, D) it returns o (B, H, S, D) in q's
// dtype and q's strides:
//
//   o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / G, j] / sqrt(D)) v[..]
//
// with G = H / Hkv query heads per kv head (GQA: q head h reads kv head
// h / G, as the Pallas kernel's kvmap does), an online softmax with m and
// l in fp32, a causal mask q_pos >= k_pos with positions counted from 0 on
// both axes (S != T included), masked logits -1e30, key tiles wholly above
// the diagonal skipped, and o = acc / max(l, 1e-37).  Rows past S and keys
// past T are masked, so any S >= 1 and T >= 1 work.  Each operand is a
// strided view with a unit stride along D, so the layers' (B, S, H, D)
// tensors permuted to (B, H, S, D) are read and written in place.
//
// Bound: operations.  At the prefill shape (B=8, S=T=1024, H=9, Hkv=3,
// D=64, causal, bf16) the two products do 4*B*H*D*S(S+1)/2 = 9.67 GFLOP
// against 25 MB of operands: 0.0098 ms at the bf16 dense tensor-core rate
// (989 TFLOP/s) and 0.0075 ms at 3.35 TB/s.
//
// Two hand-written kernels; the wrapper picks one by dtype and head dim
// before the launch (never as a fallback after a failed one):
//
// * fa_forward_wgmma, for bf16 with D in {64, 112, 128} (the prefill of
//   every dense LM config and zamba2's shared block): the tensor-core
//   kernel below (namespace tc).
//   - Roles.  A CTA of three warpgroups: warpgroups 0 and 1 consume 64 q
//     rows each of a 128-row q tile; one thread of warpgroup 2 produces.
//     setmaxnreg hands the producer's registers (down to 24) to the
//     consumers (up to 240) at run time, but ptxas compiles the consumers
//     within the 168 registers a thread of a 384-thread CTA starts with
//     (a variant that needed more spilled), so the tiles are sized to that.
//   - Persistent.  min(SMs, tiles) CTAs walk the (q tile, head, batch)
//     tiles heaviest first, in a snake (tile_at).  Q is loaded once per q
//     tile, as soon as the consumers are done with the previous one; K and
//     V stream through a ring of kStages stages that runs on across tiles,
//     with full barriers for K and for V and one empty barrier that the
//     consumers' eight warps release.
//   - TMA.  The host side encodes one 4-D tensor map per operand over
//     (D, rows, heads, B) with the operand's own byte strides (found at
//     run time through cudaGetDriverEntryPoint, so the library needs no
//     -lcuda) and passes it as a __grid_constant__ CUtensorMap.  Boxes are
//     64 columns (128 bytes) wide with the 128-byte swizzle; D=128 takes
//     two boxes per tile.  A box that reaches past S or T (or past a head:
//     each axis is bounded on its own) is zero-filled, and its mbarrier
//     still expects the whole box's bytes.
//   - D = 112 (zamba2-7b) runs as D = 128 in shared memory and in the
//     products (padded<D>): the maps keep the true 112 as their dim 0, so
//     the second box reads columns 64-111 and TMA zero-fills 112-127 (a
//     dim 0 of 128 would read the next head's first 16 columns, since the
//     layers hand in (B, S, H, D) views).  Q K^T then adds exact zeros
//     over its last k16 step, P V gives zeros in columns 112-127, and the
//     epilogue stores the columns below D only: o's rows run on into the
//     next head's, which another CTA writes.  The registers are D = 128's
//     (O is 64 fp32 a thread); the tensor work is 8/7 of the unpadded.
//   - S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory
//     under the same 128-byte swizzle as the TMA map; a k16 step advances
//     the descriptor's start address by 32 bytes inside a 1024-byte atom.
//   - Softmax in registers, in the accumulator's layout: each thread holds
//     two rows of the tile, a row's four threads meet by quad shuffles,
//     exp2 on the special-function unit with scale * log2(e) folded into
//     one FMA, masking only in key tiles that reach the causal diagonal or
//     the end of T.  No shared memory and no __syncthreads.
//   - O += P V: tensor cores take P in bf16, but the Pallas kernel keeps p
//     in fp32.  Rounding p once to bf16 misses the card tolerance
//     (ATTN_TOL, two bf16 steps) on every bf16 case of cases.ATTN_GRID
//     with more than one live key in a row; P = P_hi + P_lo, two bf16
//     terms, meets it on all of them (tests/test_torch_kernels.py
//     emulates both on the CPU).  So the S accumulator is converted in
//     registers into the A fragments of P_hi = bf16(p) and P_lo =
//     bf16(p - P_hi), and two register-operand wgmmas (m64nDk16, V
//     MN-major through the transpose bit) add both into one fp32 O, after
//     O is rescaled by the row's correction.  That is 1.5x the product's
//     tensor work (0.0147 ms at the prefill shape).
//   - Bursts.  Per key tile j a consumer issues S_j and P_{j-1} V_{j-1}
//     together and waits for S_j alone first.  ptxas still places the wait
//     for P_{j-1} V before the softmax's exponentials, because it writes
//     the new P into the registers that product reads (a second P register
//     set did not keep them apart), so within a warpgroup the softmax does
//     not overlap its own products.
//   - Key tiles are 64 rows: S (32 fp32), P_hi and P_lo (16 registers
//     each) and O (32 or 64 fp32) fit the consumers' registers with S_j
//     and P_{j-1} live together.  Under the causal mask warpgroup 0 skips
//     the key tiles wholly above its 64 rows and only releases their
//     stages.
//   - The epilogue multiplies by the reciprocal of max(l, 1e-37) (one
//     fp32 rounding from the quotient), rounds to bf16 once and stores
//     through o's strides; rows past S are not written.
// * fa_forward, the scalar kernel (namespace below): fp32 at any D, which
//   the fp32 copy of a model and its 2e-5 tolerance need, and bf16 with D
//   in {16, 32} (the reduced configs), too narrow for wgmma's 128-byte
//   (64-column) swizzle atoms to be worth padding.
//   One CTA of 256 threads per (q tile of 64 rows, head, batch) stages Q,
//   K and V in shared memory as fp32, computes the 64 x 64 score tile with
//   scalar FMAs (each thread a 4 x 4 block, read as float4 along D),
//   updates m, l and the per-row rescale factor with four threads per row,
//   and adds P V into an fp32 accumulator in registers (each thread 4 rows
//   x D/16 columns).  It runs on the fp32 units (67 TFLOP/s peak).
#include <cuda.h>           // CUtensorMap and its enums only: no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                   // query rows per CTA
constexpr int kBK = 64;                   // key rows per tile
constexpr int kThreads = 256;
constexpr int kColGroups = 16;            // threads along a tile's columns
constexpr int kRowGroups = kThreads / kColGroups;
constexpr int kRowsPerThread = kBQ / kRowGroups;   // 4
constexpr int kColsPerThread = kBK / kColGroups;   // 4
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Element strides of one operand's batch, head and row axes; D is unit.
struct Strides {
  long long b, h, s;
};

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 4) + kBK * (D + 4) + kBK * D + kBQ * (kBK + 4) + 3 * kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, Strides qs,
                     Strides ks, Strides vs, Strides os, int H, int Hkv,
                     int S, int Tk, int causal, float scale) {
  static_assert(D % kColGroups == 0 && D % 4 == 0, "D must divide by 16");
  constexpr int kQStride = D + 4;         // padded: float4 reads of rows
  constexpr int kKStride = D + 4;         // 16 apart hit distinct banks
  constexpr int kSStride = kBK + 4;
  constexpr int kDCols = D / kColGroups;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // kBQ x kQStride
  float* sK = sQ + kBQ * kQStride;               // kBK x kKStride
  float* sV = sK + kBK * kKStride;               // kBK x D
  float* sS = sV + kBK * D;                      // kBQ x kSStride: s, then p
  float* sM = sS + kBQ * kSStride;               // running max per row
  float* sL = sM + kBQ;                          // running sum per row
  float* sC = sL + kBQ;                          // this tile's rescale

  const int tid = threadIdx.x;
  const int tx = tid % kColGroups;
  const int ty = tid / kColGroups;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;
  T* op = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    sQ[r * kQStride + d] = qi < S ? to_f32(qp[qi * qs.s + d]) : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }
  float acc[kRowsPerThread][kDCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[i][j] = 0.f;
  }

  // Key tiles that start past the tile's last query row are masked for
  // every row: under the causal mask the walk stops before them.
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile's sK, sV and sS are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int kj = k0 + r;
      const bool in = kj < Tk;
      sK[r * kKStride + d] = in ? to_f32(kp[kj * ks.s + d]) : 0.f;
      sV[r * D + d] = in ? to_f32(vp[kj * vs.s + d]) : 0.f;
    }
    __syncthreads();

    // s = q k^T * scale, masked; thread (ty, tx) owns rows ty + 16 i and
    // columns tx + 16 j.
    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRowsPerThread], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(
            &sQ[(ty + i * kRowGroups) * kQStride + d]);
      }
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(
            &sK[(tx + j * kColGroups) * kKStride + d]);
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          s[i][j] += qv[i].x * kv[j].x;
          s[i][j] += qv[i].y * kv[j].y;
          s[i][j] += qv[i].z * kv[j].z;
          s[i][j] += qv[i].w * kv[j].w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty + i * kRowGroups;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int c = tx + j * kColGroups;
        const int kj = k0 + c;
        const bool live = kj < Tk && (!causal || q0 + r >= kj);
        sS[r * kSStride + c] = live ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: four neighbouring lanes per row.  Every lane reads
    // sM[r] before the shuffles, and lane 0 writes it after them.
    {
      const int r = tid / 4, part = tid % 4;
      float* row = sS + r * kSStride;
      float mx = kNegInf;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < kBK; c += 4) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        sM[r] = m_new;
        sL[r] = sL[r] * corr + sum;
        sC[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v; thread (ty, tx) owns rows ty + 16 i and
    // columns tx + 16 j.
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const float corr = sC[ty + i * kRowGroups];
#pragma unroll
      for (int j = 0; j < kDCols; ++j) acc[i][j] *= corr;
    }
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 p[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        p[i] = *reinterpret_cast<const float4*>(
            &sS[(ty + i * kRowGroups) * kSStride + c]);
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[kDCols];
#pragma unroll
        for (int j = 0; j < kDCols; ++j) {
          vv[j] = sV[(c + cc) * D + tx + j * kColGroups];
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float pi = cc == 0 ? p[i].x
                           : cc == 1 ? p[i].y
                           : cc == 2 ? p[i].z
                                     : p[i].w;
#pragma unroll
          for (int j = 0; j < kDCols; ++j) acc[i][j] += pi * vv[j];
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty + i * kRowGroups;
    const int qi = q0 + r;
    if (qi >= S) continue;
    const float l = fmaxf(sL[r], 1e-37f);
#pragma unroll
    for (int j = 0; j < kDCols; ++j) {
      store(op + qi * os.s + tx + j * kColGroups, acc[i][j] / l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides qs, Strides ks, Strides vs, Strides os, int B,
                   int H, int Hkv, int S, int Tk, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, H, Hkv,
      S, Tk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, Strides qs, Strides ks, Strides vs, Strides os,
                     int B, int H, int Hkv, int S, int Tk, int causal,
                     float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, qs, ks, vs, os, B, H, Hkv, S, Tk,
                           causal, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, qs, ks, vs, os, B, H, Hkv, S, Tk,
                           causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, qs, ks, vs, os, B, H, Hkv, S, Tk,
                           causal, scale, stream);
    case 112:   // zamba2's shared attention block; about 106 KB of smem
      return launch<T, 112>(q, k, v, o, qs, ks, vs, os, B, H, Hkv, S, Tk,
                            causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, qs, ks, vs, os, B, H, Hkv, S, Tk,
                            causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// ------------------------------------------------ tensor-core variant (bf16)
namespace {
namespace tc {

constexpr int kBM = 128;        // q rows per CTA: two consumer warpgroups
constexpr int kStages = 3;      // K/V ring depth
constexpr int kThreads = 384;   // warpgroups 0, 1 consume; 2 produces
constexpr int kAtomBytes = 128; // one swizzle atom row: 64 bf16
constexpr int kBN = 64;         // keys per tile (see the note at the top)

// The head dim in shared memory and in the products: D rounded up to whole
// 64-column swizzle atoms (112 -> 128; the TMA loads zero-fill the rest).
template <int D>
__host__ __device__ constexpr int padded() {
  return (D + 63) / 64 * 64;
}

// Bytes of shared memory: Q, the K and V rings, the barriers, and slack to
// align the tiles to the 1024-byte swizzle period.
template <int D>
struct Layout {
  static constexpr int kQ = kBM * padded<D>() * 2;
  static constexpr int kKV = kBN * padded<D>() * 2;
  static constexpr int kK = kQ;                       // K ring offset
  static constexpr int kV = kK + kStages * kKV;       // V ring offset
  static constexpr int kBar = kV + kStages * kKV;     // barriers offset
  static constexpr int kBytes = kBar + 8 * (2 + 3 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the barrier's phase of the given parity has completed.  A
// wait that outlasts 2^24 polls (seconds; a real one takes microseconds)
// traps, so a pipeline fault ends the launch with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// One box of a 4-D map, coordinates innermost first, into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor under the 128-byte swizzle: start
// address, leading and stride byte offsets (all >> 4), layout type 1.
// K-major operands (Q, K): SBO = 1024, the stride of 8-row groups; LBO is
// unused.  MN-major V: SBO = 1024 between 8-key groups, LBO = the stride
// between 64-column atoms along D.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of a register that an
// asynchronous wgmma owns across the fence/commit/wait instructions.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64, fp32) {+}= A (64 x 16) B (16 x 64), A and B bf16 in shared
// memory, both K-major, named by descriptors; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, fp32) += A (64 x 16, bf16, four registers a) B (16 x 64),
// B bf16 in shared memory, MN-major (the transpose bit), by descriptor.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16, four registers a) B (16 x 128),
// B bf16 in shared memory, MN-major (the transpose bit), by descriptor.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, b);
  } else {
    wgmma_rs_n128(d, a, b);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// exp2 on the special-function unit, subnormal results flushed to 0.
// exp2f adds a subnormal-range fixup around the same instruction; a p
// below 2^-126 cannot move a row sum whose largest term is 1.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One consumer thread's share of the online softmax of the key tile at n0
// (kBN / 2 scores of its two rows, in the accumulator's layout): in a tile
// that reaches `masked`, the first key masked for any row of the q tile
// (the causal diagonal or the end of T), masks each row's keys past
// lim[r] + the thread's first column; updates the running maxima m and
// partial sums l, returns the rows' rescale factors in corr, and leaves
// p = exp(scale (s - m)) in s.
__device__ __forceinline__ void softmax_tile(float (&s)[kBN / 2], int n0,
                                             int masked, const int (&lim)[2],
                                             float scale_log2, float (&m)[2],
                                             float (&l)[2], float (&corr)[2]) {
  if (n0 + kBN > masked) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      // column of score i, less the thread's first column: a constant
      if (8 * (i / 4) + (i & 1) > lim[(i >> 1) & 1] - n0) s[i] = kNegInf;
    }
  }
  // Running max per row: this thread's columns, then the quad's.
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = exp2_ftz((m[r] - mx[r]) * scale_log2);
    m[r] = mx[r];
    mx[r] *= scale_log2;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2_ftz(fmaf(s[i], scale_log2, -mx[r]));
    sum[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

// p (fp32, accumulator layout) -> the A fragments of P_hi = bf16(p) and
// P_lo = bf16(p - P_hi).  The pair (p[i], p[i+1]) is one row's two
// neighbouring columns, and register i/2 of a fragment list is exactly
// wgmma's A layout for key step i/8.
__device__ __forceinline__ void split_p(const float (&p)[kBN / 2],
                                        uint32_t (&hi)[kBN / 4],
                                        uint32_t (&lo)[kBN / 4]) {
#pragma unroll
  for (int i = 0; i < kBN / 2; i += 2) {
    const uint32_t h = pack_bf16(p[i], p[i + 1]);
    hi[i / 2] = h;
    lo[i / 2] = pack_bf16(p[i] - __uint_as_float(h << 16),
                          p[i + 1] - __uint_as_float(h & 0xffff0000u));
  }
}

// S = Q K^T for one warpgroup's 64 rows (q_rows) and one key tile, in
// padded<D>() / 16 k16 steps (the zero-filled columns past D add exact
// zeros); both operands K-major under the 128-byte swizzle.
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[kBN / 2], uint32_t q_rows,
                                        uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < padded<D>() / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;        // 16 columns of the atom
    wgmma_ss_n64(s, sw128_desc(q_rows + (kk / 4) * kBM * kAtomBytes + off, 16),
                 sw128_desc(k_tile + (kk / 4) * kBN * kAtomBytes + off, 16),
                 kk > 0);
  }
}

// O += P_hi V + P_lo V over one key tile, in kBN / 16 k16 steps each, over
// padded<D>() columns (those past D come out zero); V is MN-major, its
// 64-column atoms kBN * 128 bytes apart.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[padded<D>() / 2],
                                         const uint32_t (&hi)[kBN / 4],
                                         const uint32_t (&lo)[kBN / 4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    wgmma_rs<padded<D>()>(
        acc, hi + 4 * kk,
        sw128_desc(v_tile + kk * 16 * kAtomBytes, kBN * kAtomBytes));
  }
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    wgmma_rs<padded<D>()>(
        acc, lo + 4 * kk,
        sw128_desc(v_tile + kk * 16 * kAtomBytes, kBN * kAtomBytes));
  }
}

// One q tile of the persistent schedule: the tiles are ordered heaviest
// first (the last q tile of every (batch, head) first, under the causal
// mask the one with the most key tiles), and CTA c of G takes tile c of
// every even round of G tiles and tile G - 1 - c of every odd round (a
// snake, which balances the sorted work as well as greedy scheduling).
struct Tile {
  int b, h, q0, n_tiles;
};

__device__ __forceinline__ bool tile_at(int round, int B, int H, int S,
                                        int Tk, int causal, Tile* tile) {
  const int G = gridDim.x;
  const int t = round * G + ((round & 1) ? G - 1 - blockIdx.x : blockIdx.x);
  const int n_q = (S + kBM - 1) / kBM;
  if (t >= n_q * B * H) return false;
  const int bh = t % (B * H);
  tile->b = bh / H;
  tile->h = bh % H;
  tile->q0 = (n_q - 1 - t / (B * H)) * kBM;
  const int q_last = min(tile->q0 + kBM, S) - 1;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  tile->n_tiles = (k_end + kBN - 1) / kBN;
  return true;
}

// A persistent grid of at most one CTA per SM walks its q tiles (see
// tile_at); the producer loads a tile's Q as soon as the consumers are done
// with the previous one's, and the K/V ring runs on across tiles, so one
// tile's loads overlap the previous tile's last products and epilogue.
//
// Per q tile, each consumer warpgroup runs one burst of wgmmas per key
// tile j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} (hi, then lo) together;
// O is rescaled by tile j's correction once that product is done and
// before P_j V_j is issued in the next burst.  Burst 0 holds S_0 only and
// burst n_tiles the last P V only.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, Strides os, int B,
                    int H, int Hkv, int S, int Tk, int causal,
                    float scale_log2) {
  static_assert(D == 64 || D == 112 || D == 128,
                "the tensor-core kernel takes D 64, 112, 128");
  using L = Layout<D>;
  constexpr int kDp = padded<D>();             // columns in shared memory
  constexpr int kChunks = kDp / 64;            // 64-column swizzle atoms
  extern __shared__ uint8_t smem_raw[];
  // Tiles start on the 1024-byte swizzle period.
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sbase = smem_addr(smem);
  const uint32_t sQ = sbase, sK = sbase + L::kK, sV = sbase + L::kV;
  const uint32_t bar = sbase + L::kBar;
  const uint32_t q_full = bar, q_empty = bar + 8;
  auto full_k = [&](int st) { return bar + 8 * (2 + st); };
  auto full_v = [&](int st) { return bar + 8 * (2 + kStages + st); };
  auto empty = [&](int st) { return bar + 8 * (2 + 2 * kStages + st); };
  // Phase parity of the n-th use of a ring stage (n counts key tiles).
  auto parity = [](int n) { return static_cast<uint32_t>((n / kStages) & 1); };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);                     // the consumers' 8 warps
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup index, made warp-uniform for the compiler so that the
  // wgmma descriptors built from it stay in uniform registers.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  Tile tile;
  if (wg == 2) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int n = 0;                               // key tiles loaded so far
      for (int r = 0; tile_at(r, B, H, S, Tk, causal, &tile); ++r) {
        const int hk = tile.h / (H / Hkv);
        mbar_wait(q_empty, (r & 1) ^ 1);
        mbar_expect_tx(q_full, L::kQ);
        for (int c = 0; c < kChunks; ++c) {
          tma_load(sQ + c * kBM * kAtomBytes, &tm_q, q_full, c * 64, tile.q0,
                   tile.h, tile.b);
        }
        for (int j = 0; j < tile.n_tiles; ++j, ++n) {
          const int st = n % kStages;
          mbar_wait(empty(st), parity(n) ^ 1);
          const uint32_t k_dst = sK + st * L::kKV, v_dst = sV + st * L::kKV;
          mbar_expect_tx(full_k(st), L::kKV);
          for (int c = 0; c < kChunks; ++c) {
            tma_load(k_dst + c * kBN * kAtomBytes, &tm_k, full_k(st), c * 64,
                     j * kBN, hk, tile.b);
          }
          mbar_expect_tx(full_v(st), L::kKV);
          for (int c = 0; c < kChunks; ++c) {
            tma_load(v_dst + c * kBN * kAtomBytes, &tm_v, full_v(st), c * 64,
                     j * kBN, hk, tile.b);
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int cq = 2 * (lane % 4);   // first column of each 8-column group
    const uint32_t q_rows = sQ + wg * 64 * kAtomBytes;
    auto k_tile = [&](int n) { return sK + (n % kStages) * L::kKV; };
    auto v_tile = [&](int n) { return sV + (n % kStages) * L::kKV; };
    float acc[kDp / 2], s[kBN / 2], m[2], l[2], corr[2];
    uint32_t p_hi[kBN / 4], p_lo[kBN / 4];

    int n = 0;                                 // key tiles consumed so far
    for (int r = 0; tile_at(r, B, H, S, Tk, causal, &tile); ++r) {
      const int nt = tile.n_tiles;
      // This thread's first row of the tile (the second is 8 below), and
      // the last key each of its two rows sees, less its first column.
      const int row0 = tile.q0 + wg * 64 + warp * 16 + lane / 4;
      const int lim[2] = {
          (causal ? min(Tk - 1, row0) : Tk - 1) - cq,
          (causal ? min(Tk - 1, row0 + 8) : Tk - 1) - cq};
      const int masked = causal ? min(tile.q0 + 1, Tk) : Tk;
      // This warpgroup's key tiles: under the causal mask warpgroup 0
      // stops before the tiles wholly above its 64 rows.
      const int nw =
          causal ? min(nt, (min(Tk, tile.q0 + 64 * (wg + 1)) + kBN - 1) / kBN)
                 : nt;
#pragma unroll
      for (int i = 0; i < kDp / 2; ++i) acc[i] = 0.f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;

      // The bursts are peeled so that no wgmma sits under a branch: ptxas
      // serialises wgmmas issued on divergent paths.
      mbar_wait(q_full, r & 1);
      mbar_wait(full_k(n % kStages), parity(n));   // burst 0: S_0
      wgmma_fence();
      issue_s<D>(s, q_rows, k_tile(n));
      wgmma_commit();
      wgmma_wait<0>();
      hold(s);
      if (nw == 1 && lane == 0) mbar_arrive(q_empty);
      softmax_tile(s, 0, masked, lim, scale_log2, m, l, corr);
      split_p(s, p_hi, p_lo);
      for (int j = 1; j < nw; ++j) {           // bursts 1 .. nw - 1
        mbar_wait(full_k((n + j) % kStages), parity(n + j));
        mbar_wait(full_v((n + j - 1) % kStages), parity(n + j - 1));
        hold(acc);
        wgmma_fence();
        issue_s<D>(s, q_rows, k_tile(n + j));
        wgmma_commit();
        issue_pv<D>(acc, p_hi, p_lo, v_tile(n + j - 1));
        wgmma_commit();
        wgmma_wait<1>();                       // S_j; P_{j-1} V may still run
        hold(s);
        if (j == nw - 1 && lane == 0) mbar_arrive(q_empty);   // Q is done
        softmax_tile(s, j * kBN, masked, lim, scale_log2, m, l, corr);
        wgmma_wait<0>();
        hold(acc);
        hold(p_hi);
        hold(p_lo);
        if (lane == 0) mbar_arrive(empty((n + j - 1) % kStages));
#pragma unroll
        for (int i = 0; i < kDp / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
        split_p(s, p_hi, p_lo);
      }
      mbar_wait(full_v((n + nw - 1) % kStages),   // the last burst: P V
                parity(n + nw - 1));
      hold(acc);
      wgmma_fence();
      issue_pv<D>(acc, p_hi, p_lo, v_tile(n + nw - 1));
      wgmma_commit();
      wgmma_wait<0>();
      hold(acc);
      hold(p_hi);
      hold(p_lo);
      if (lane == 0) mbar_arrive(empty((n + nw - 1) % kStages));
      // Stages of the tiles this warpgroup skips go back once loaded: then
      // the release counts toward that fill, not the stage's previous one.
      for (int j = nw; j < nt; ++j) {
        mbar_wait(full_k((n + j) % kStages), parity(n + j));
        if (lane == 0) mbar_arrive(empty((n + j) % kStages));
      }
      n += nt;

      // Epilogue: the quad's partial sums, o = acc / max(l, 1e-37) (as a
      // product with the reciprocal, one fp32 rounding apart) rounded once
      // to bf16, stored through o's strides; rows past S and the padded
      // columns past D are not written (o's row may run on into the next
      // head's, which another CTA writes).
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        l[i] = 1.f / fmaxf(l[i], 1e-37f);
      }
      __nv_bfloat16* op = o + tile.b * os.b + tile.h * os.h;
#pragma unroll
      for (int g = 0; g < D / 8; ++g) {   // 8-column groups below D
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = row0 + 8 * i;
          if (row < S) {
            *reinterpret_cast<__nv_bfloat162*>(op + row * os.s + 8 * g + cq) =
                __floats2bfloat162_rn(acc[4 * g + 2 * i] * l[i],
                                      acc[4 * g + 2 * i + 1] * l[i]);
          }
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) {
      return cudaErrorNotSupported;
    }
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A 4-D map over (D, rows, heads, B) of a bf16 operand with the given
// element strides of its batch, head and row axes: boxes of 64 columns by
// `box_rows` rows of one head, 128-byte swizzle, zero fill past the ends.
cudaError_t make_map(EncodeTiled encode, CUtensorMap* map, const void* base,
                     int D, int rows, int heads, int B, long long sb,
                     long long sh, long long ss, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const long long* st, int B, int H, int Hkv, int S, int Tk,
                   int causal, float scale, cudaStream_t stream) {
  EncodeTiled encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if ((err = make_map(encode, &tq, q, D, S, H, B, st[0], st[1], st[2],
                      kBM)) != cudaSuccess ||
      (err = make_map(encode, &tk, k, D, Tk, Hkv, B, st[3], st[4], st[5],
                      kBN)) != cudaSuccess ||
      (err = make_map(encode, &tv, v, D, Tk, Hkv, B, st[6], st[7], st[8],
                      kBN)) != cudaSuccess) {
    return err;
  }
  constexpr int smem = Layout<D>::kBytes;
  int device, sms;
  if ((err = cudaFuncSetAttribute(fa_wgmma_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess ||
      (err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return err;
  }
  const long long tiles = static_cast<long long>((S + kBM - 1) / kBM) * B * H;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  fa_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o),
      Strides{st[9], st[10], st[11]}, B, H, Hkv, S, Tk, causal,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace

extern "C" {

// The scalar kernel.  q, o: (B, H, S, D); k, v: (B, Hkv, T, D); fp32
// (dtype 0) or bf16 (dtype 1), each with the given element strides of its
// first three axes and a unit stride along D, on `device`.  D is 16, 32,
// 64, 112 or 128 and H a multiple of Hkv.  Returns the launch's cudaError_t (0 on
// success).
int fa_forward(const void* q, const void* k, const void* v, void* o,
               int dtype, int B, int H, int Hkv, int S, int T, int D,
               long long qsb, long long qsh, long long qss, long long ksb,
               long long ksh, long long kss, long long vsb, long long vsh,
               long long vss, long long osb, long long osh, long long oss,
               int causal, float scale, int device, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || S < 1 || T < 1 ||
      H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch_d<float>(D, q, k, v, o, qs, ks, vs, os, B, H, Hkv, S, T,
                            causal, scale, s);
      break;
    case 1:
      err = launch_d<__nv_bfloat16>(D, q, k, v, o, qs, ks, vs, os, B, H, Hkv,
                                    S, T, causal, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The tensor-core kernel: q, o (B, H, S, D) and k, v (B, Hkv, T, D), all
// bf16, with the given element strides of their first three axes (q's,
// k's, v's, then o's, each batch, head, row) and a unit stride along D,
// on `device`.  D is 64, 112 or 128 and H a multiple of Hkv.  TMA needs
// 16-byte aligned q, k, v and byte strides that are multiples of 16; a map
// it refuses returns cudaErrorInvalidValue.  Returns the cudaError_t.
int fa_forward_wgmma(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int Hkv, int S, int T, int D,
                     const long long* strides, int causal, float scale,
                     int device, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || S < 1 || T < 1 ||
      static_cast<long long>((S + tc::kBM - 1) / tc::kBM) * B * H >
          0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      err = tc::launch<64>(q, k, v, o, strides, B, H, Hkv, S, T, causal,
                           scale, s);
      break;
    case 112:   // zamba2's shared attention block, padded to 128
      err = tc::launch<112>(q, k, v, o, strides, B, H, Hkv, S, T, causal,
                            scale, s);
      break;
    case 128:
      err = tc::launch<128>(q, k, v, o, strides, B, H, Hkv, S, T, causal,
                            scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory per CTA of the tensor-core kernel at head dim D.
int fa_wgmma_smem_bytes(int D) {
  return D == 64    ? tc::Layout<64>::kBytes
         : D == 112 ? tc::Layout<112>::kBytes
         : D == 128 ? tc::Layout<128>::kBytes
                    : 0;
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
