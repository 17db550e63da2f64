// Flash-decode partials for Hopper (sm_90a), bound to PyTorch by ctypes.
//
// Replaces repro/kernels/flash_decode.py flash_decode_partial, the Pallas
// kernel of one decode step's attention over a (local) KV-cache slice.
// Given q (B, H, D), caches (B, T, Hkv, D), a position `pos` read from
// device memory and the slice's global offset `kv_offset`, it returns the
// unnormalised partials
//
//   m[b, h] = max_t s,  l[b, h] = sum_t exp(s - m),
//   o[b, h] = sum_t exp(s - m) v[b, t, h / G],
//   s = q[b, h] . k[b, t, h / G] / sqrt(D),
//
// all fp32, over the rows with kv_offset + t <= pos; the combine across
// slices (o / l) runs outside.  As in the Pallas kernel, m starts at
// -1e30, masked rows score -1e30, and key blocks whose first row lies past
// `pos` are skipped, so a slice wholly after `pos` gives m = -1e30, l = 0
// and o = 0.  `pos` stays on the device: the caller never syncs for it.
//
// Design.  One CTA of 128 threads per (kv head, batch row): the G query
// heads that share a kv head share every K/V row the CTA reads.  The CTA
// walks the cache in blocks of 64 rows up to `pos`, stages K and V in
// shared memory as fp32, scores G x 64 with scalar FMAs, updates m, l and
// the rescale factor with one warp per head, and adds P V into fp32
// registers (G * D / 128 values per thread).
//
// Bound: bytes.  The step reads the cache rows up to `pos` once: at
// B=8, Hkv=3, D=64, bf16 and pos ~1088 that is 6.7 MB of K and V, 0.002 ms
// at 3.35 TB/s; the arithmetic is 4*B*H*D*(pos+1) = 20 MFLOP.  With one CTA
// per (kv head, batch row) that shape launches only B*Hkv = 24 CTAs on the
// card's 132 SMs, so the kernel cannot draw the card's bandwidth; splitting
// the cache across CTAs (split-KV) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;                   // cache rows per block
constexpr int kAcc = 16;                  // output values per thread
constexpr int kMaxGD = kThreads * kAcc;   // G * D the registers hold
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int D>
size_t smem_bytes(int G) {
  return sizeof(float) *
         (static_cast<size_t>(G) * D + kBK * (D + 1) + kBK * D + G * kBK +
          3 * G);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int32_t* __restrict__ pos_ptr,
                        float* __restrict__ o, float* __restrict__ l,
                        float* __restrict__ m, int Hkv, int G, int Tk,
                        int kv_offset, float scale) {
  constexpr int kKStride = D + 1;   // rows read down a column: no conflicts
  extern __shared__ float smem[];
  float* sQ = smem;                 // G x D
  float* sK = sQ + G * D;           // kBK x kKStride
  float* sV = sK + kBK * kKStride;  // kBK x D
  float* sP = sV + kBK * D;         // G x kBK: s, then p
  float* sM = sP + G * kBK;         // running max per head
  float* sL = sM + G;               // running sum per head
  float* sC = sL + G;               // this block's rescale

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int H = Hkv * G;
  const int pos = *pos_ptr;
  // the G query heads of kv head hk are contiguous: h = hk * G + g
  const int64_t head0 = static_cast<int64_t>(b) * H + hk * G;
  const T* qp = q + head0 * D;
  const int64_t row_stride = static_cast<int64_t>(Hkv) * D;
  const T* kp = kc + static_cast<int64_t>(b) * Tk * row_stride + hk * D;
  const T* vp = vc + static_cast<int64_t>(b) * Tk * row_stride + hk * D;

  for (int i = tid; i < G * D; i += kThreads) sQ[i] = to_f32(qp[i]);
  for (int g = tid; g < G; g += kThreads) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < Tk && kv_offset + t0 <= pos; t0 += kBK) {
    __syncthreads();   // the previous block's sK, sV and sP are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int t = t0 + r;
      const bool in = t < Tk;
      sK[r * kKStride + d] = in ? to_f32(kp[t * row_stride + d]) : 0.f;
      sV[r * D + d] = in ? to_f32(vp[t * row_stride + d]) : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < G * kBK; i += kThreads) {
      const int g = i / kBK, r = i % kBK;
      const float* qg = sQ + g * D;
      const float* kr = sK + r * kKStride;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s += qg[d] * kr[d];
      const bool live = t0 + r < Tk && kv_offset + t0 + r <= pos;
      sP[i] = live ? s * scale : kNegInf;
    }
    __syncthreads();

    // one warp per head, two of the block's 64 rows per lane
    for (int g = warp; g < G; g += kWarps) {
      float* row = sP + g * kBK;
      const float a = row[lane], c = row[lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      row[lane] = pa;
      row[lane + 32] = pc;
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sM[g] = m_new;
        sL[g] = sL[g] * corr + sum;
        sC[g] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < G * D) {
        const int g = e / D, d = e % D;
        const float* pg = sP + g * kBK;
        float a = acc[i] * sC[g];
#pragma unroll 8
        for (int r = 0; r < kBK; ++r) a += pg[r] * sV[r * D + d];
        acc[i] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * D) o[head0 * D + e] = acc[i];
  }
  for (int g = tid; g < G; g += kThreads) {
    l[head0 + g] = sL[g];
    m[head0 + g] = sM[g];
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* pos, void* o, void* l, void* m, int B,
                   int Hkv, int G, int Tk, int kv_offset, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(G);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, B);
  flash_decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int32_t*>(pos),
      static_cast<float*>(o), static_cast<float*>(l), static_cast<float*>(m),
      Hkv, G, Tk, kv_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* kc, const void* vc,
                     const void* pos, void* o, void* l, void* m, int B,
                     int Hkv, int G, int Tk, int kv_offset, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, kc, vc, pos, o, l, m, B, Hkv, G, Tk, kv_offset,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, kc, vc, pos, o, l, m, B, Hkv, G, Tk, kv_offset,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, kc, vc, pos, o, l, m, B, Hkv, G, Tk, kv_offset,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, kc, vc, pos, o, l, m, B, Hkv, G, Tk,
                            kv_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (B, Hkv * G, D); k_cache, v_cache: (B, T, Hkv, D), fp32 (dtype 0) or
// bf16 (dtype 1); pos: one int32; o: (B, H, D), l, m: (B, H) fp32.  All
// contiguous on `device`.  D is 16, 32, 64 or 128 and G * D <= 2048.
// Returns the launch's cudaError_t (0 on success).
int fd_partial(const void* q, const void* k_cache, const void* v_cache,
               const void* pos, void* o, void* l, void* m, int dtype, int B,
               int Hkv, int G, int T, int D, int kv_offset, float scale,
               int device, void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || G < 1 || T < 1 || G * D > kMaxGD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch_d<float>(D, q, k_cache, v_cache, pos, o, l, m, B, Hkv, G,
                            T, kv_offset, scale, s);
      break;
    case 1:
      err = launch_d<__nv_bfloat16>(D, q, k_cache, v_cache, pos, o, l, m, B,
                                    Hkv, G, T, kv_offset, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* fd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
