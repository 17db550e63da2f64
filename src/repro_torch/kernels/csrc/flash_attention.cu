// Flash-attention forward for Hopper (sm_90a), bound to PyTorch by ctypes.
//
// Replaces repro/kernels/flash_attention.py flash_attention, the Pallas
// kernel of the prefill attention.  Given q (B, H, S, D) and k, v
// (B, Hkv, T, D) it returns o (B, H, S, D) in q's dtype:
//
//   o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / G, j] / sqrt(D)) v[..]
//
// with G = H / Hkv query heads per kv head (GQA: q head h reads kv head
// h / G, as the Pallas kernel's kvmap does), an online softmax in fp32, a
// causal mask q_pos >= k_pos with positions counted from 0 on both axes,
// masked logits -1e30, key tiles wholly above the diagonal skipped, and
// o = acc / max(l, 1e-37).
//
// Design.  One CTA of 256 threads per (q tile of 64 rows, head, batch).
// The CTA stages its Q tile in shared memory once, then walks the key
// tiles (64 rows each) up to the diagonal: it stages K and V in shared
// memory as fp32, computes the 64 x 64 score tile with scalar FMAs (each
// thread a 4 x 4 block, read as float4 along D), updates the running max
// m, sum l and the per-row rescale factor with four threads per row, and
// adds P V into an fp32 accumulator that lives in registers (each thread
// 4 rows x D/16 columns).  Rows past S and keys past T are masked, so any
// S and T work.  Each operand takes its own (batch, head, row) strides with
// a unit stride along D, so a (B, S, H, D) tensor permuted to (B, H, S, D)
// is read and written in place.
//
// Bound: operations.  At the prefill shape (B=8, S=T=1024, H=9, Hkv=3,
// D=64, causal, bf16) the two products do 4*B*H*D*S(S+1)/2 = 9.7 GFLOP
// against 25 MB of operands: 0.0098 ms at the bf16 dense tensor-core rate
// (989 TFLOP/s) and 0.0075 ms at 3.35 TB/s.  This kernel computes in fp32
// outside the tensor cores (67 TFLOP/s peak), so it cannot come near the
// bound; it is the simple, exact first version, and wgmma, TMA and a
// pipelined K/V ring are later work.
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
    case 128:
      return launch<T, 128>(q, k, v, o, qs, ks, vs, os, B, H, Hkv, S, Tk,
                            causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: (B, H, S, D); k, v: (B, Hkv, T, D); fp32 (dtype 0) or bf16 (dtype
// 1), each with the given element strides of its first three axes and a
// unit stride along D, on `device`.  D is 16, 32, 64 or 128 and H a
// multiple of Hkv.  Returns the launch's cudaError_t (0 on success).
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

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
