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
// -1e30 and rows past `pos` add nothing, so a slice wholly after `pos`
// gives m = -1e30, l = 0 and o = 0.  `pos` stays on the device: the
// caller never syncs for it.
//
// Bound: bytes.  The step reads the cache rows up to `pos` once: at
// B=8, Hkv=3, D=64, bf16 and pos 1087 that is 6.7 MB of K and V, 0.002 ms
// at 3.35 TB/s; the arithmetic is 4*B*H*D*(pos+1) = 20 MFLOP, far below
// the card's ratio of operations to bytes.  One query token per head
// gives a product of at most G rows, so the tensor cores have nothing to
// do; the kernel has to keep enough 16-byte loads in flight on every SM.
//
// Design.  Split-KV: the grid is (splits, Hkv, B).  The host picks
// `splits` from B * Hkv, T and the SM count alone (about two waves of
// CTAs; flash_decode.num_splits), never from `pos`, which it does not
// know.  Each CTA reads `pos` and cuts the n = clamp(pos - kv_offset + 1,
// 0, T) live rows into `splits` near-equal ranges itself, so every CTA
// has work whatever `pos` is and no row it reads is masked.  The G query
// heads of a kv head stay in one CTA, so each K/V row is read from device
// memory once (G > 4 runs in passes of at most 4 heads; the passes after
// the first find the CTA's rows in L1/L2).
//
// Inside a CTA each thread reads 16 bytes of a row (8 bf16 or 4 fp32
// values); D * sizeof(T) / 16 neighbouring lanes cover a row, in a lane
// group rounded up to a power of two, so a warp reads 32 / (group size)
// rows per load.  At D = 112 a row is 14 lanes in bf16 and 28 in fp32: the
// groups are 16 and 32 lanes, the spare lanes load nothing and add zero,
// and the xor trees over a group add only lanes of one row.  At D = 16,
// 32, 64 and 128 the group is the row's lanes and the code is unchanged.
// A thread starts the loads of 4 rows of K and of V before it uses the
// first, scores its piece against the G queries held in registers,
// reduces across the lanes of the row with shuffles, and keeps an online
// softmax (m, l and its slice of o) in registers.  No shared memory on the way and no barrier until the
// end, where the row groups of a warp merge by shuffles and the 4 warps
// through shared memory, in a fixed order.
//
// The merge across splits is the reference's cross-shard combine
// (repro/models/layers.py:321-324): m = max_s m_s, l = sum_s l_s e^(m_s -
// m), o = sum_s o_s e^(m_s - m), summed in split order, so two launches
// on the same inputs are bitwise equal.  It is a second small kernel on
// the same stream, reading the fp32 workspace the wrapper allocates (the
// kernels allocate nothing), launched as a programmatic dependent of the
// split kernel so that its launch overlaps the split kernel's run.  With
// splits == 1 the split kernel writes the outputs directly.
//
// Choices measured on the H100 at the smollm-135m decode shape and five
// other shapes of cases.DECODE_GRID, in throwaway harnesses (PERF.md):
// a "last CTA of the group merges" step with an integer arrival counter
// was slower than this merge kernel at every shape with splits; 8 rows
// in flight per thread instead of 4 spilled in some builds and lost at
// some shapes; 256 threads per CTA and __expf won at some shapes and
// lost at others.  The merge kernel issues the loads of up to 16 splits
// together: a loop that waited on each split's load in turn took most
// of its time.  Cutting the rows from `pos` on the device was kept over
// fixed chunks of T without measuring the latter: it gives every CTA
// work whatever `pos` is.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;          // rows of K and V in flight per thread
constexpr int kMaxHeads = 4;        // query heads per pass
constexpr int kMergeThreads = 256;
constexpr int kChunk = 16;          // splits whose loads the merge overlaps
constexpr float kNegInf = -1e30f;

// 16 bytes of a row: kVec values of T
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void widen(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void widen(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

// (m, l, acc) of one head := their merge with (m2, l2, acc2)
template <int N>
__device__ __forceinline__ void merge_into(float& m, float& l, float* acc,
                                           float m2, float l2,
                                           const float* acc2) {
  const float mx = fmaxf(m, m2);
  const float c1 = expf(m - mx), c2 = expf(m2 - mx);
  l = l * c1 + l2 * c2;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = acc[i] * c1 + acc2[i] * c2;
  m = mx;
}

// The least power of two >= n, for n >= 1
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// One CTA: rows [r0, r1) of split blockIdx.x of kv head blockIdx.y of
// batch row blockIdx.z, heads in passes of GC.  Writes (o, l, m) of the
// split to po/pl/pm at [split][b][h] (the outputs when splits == 1).
template <typename T, int D, int GC>
__global__ void __launch_bounds__(kThreads)
    fd_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc,
                    const int32_t* __restrict__ pos_ptr,
                    float* __restrict__ po, float* __restrict__ pl,
                    float* __restrict__ pm, int Hkv, int G, int Tk,
                    int kv_offset, float scale) {
  constexpr int kVec = Vec<T>::kN;
  constexpr int kDataLanes = D / kVec;              // lanes a row fills
  static_assert(D % kVec == 0 && kDataLanes <= 32, "a row fits a warp");
  constexpr int kLanesPerRow = pow2_at_least(kDataLanes);   // 2 .. 32
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;   // rows per warp load
  constexpr int kStep = kWarps * kRowsPerWarp;      // rows per CTA load
  __shared__ float sM[kWarps][GC], sL[kWarps][GC], sO[kWarps][GC][D];

  // the merge kernel may launch now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;");
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int rg = lane / kLanesPerRow;               // row in the warp load
  const int d0 = (lane % kLanesPerRow) * kVec;
  // false only on the spare lanes of a row group (D = 112); they load
  // nothing, score 0 and keep acc at 0
  const bool data = kDataLanes == kLanesPerRow || d0 < D;
  const int split = blockIdx.x, splits = gridDim.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int B = gridDim.z, H = Hkv * G;

  // this split's share of the live rows, cut on the device from pos
  const int64_t past = static_cast<int64_t>(*pos_ptr) - kv_offset + 1;
  const int64_t live = past < 0 ? 0 : (past > Tk ? Tk : past);
  const int r0 = static_cast<int>(live * split / splits);
  const int r1 = static_cast<int>(live * (split + 1) / splits);

  const int64_t row_stride = static_cast<int64_t>(Hkv) * D;
  const T* kp = kc + static_cast<int64_t>(b) * Tk * row_stride + hk * D + d0;
  const T* vp = vc + static_cast<int64_t>(b) * Tk * row_stride + hk * D + d0;
  const int64_t out0 = (static_cast<int64_t>(split) * B + b) * H + hk * G;

  for (int g0 = 0; g0 < G; g0 += GC) {
    const int gn = min(GC, G - g0);
    float qr[GC][kVec];               // heads past gn score 0, unused
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g < gn && data) {
        Vec<T>::widen(load16(q + (static_cast<int64_t>(b) * H + hk * G + g0
                                  + g) * D + d0), qr[g]);
#pragma unroll
        for (int i = 0; i < kVec; ++i) qr[g][i] *= scale;
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) qr[g][i] = 0.f;
      }
    }
    float m[GC], l[GC], acc[GC][kVec];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
    }

    // the bound is the CTA's, so every lane runs every shuffle
    for (int base = r0; base < r1; base += kUnroll * kStep) {
      uint4 kr[kUnroll], vr[kUnroll];
      bool in[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {   // every load before any use
        const int t = base + u * kStep + warp * kRowsPerWarp + rg;
        in[u] = t < r1;
        const bool ld = in[u] && data;
        kr[u] = ld ? load16(kp + t * row_stride) : make_uint4(0, 0, 0, 0);
        vr[u] = ld ? load16(vp + t * row_stride) : make_uint4(0, 0, 0, 0);
      }
      float s[kUnroll][GC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[kVec];
        Vec<T>::widen(kr[u], kf);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < kVec; ++i) a += qr[g][i] * kf[i];
          s[u][g] = a;
        }
      }
#pragma unroll
      for (int off = kLanesPerRow / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (in[u]) mx = fmaxf(mx, s[u][g]);
        }
        const float corr = expf(m[g] - mx);
        l[g] *= corr;
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[g][i] *= corr;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float p = in[u] ? expf(s[u][g] - mx) : 0.f;
          float vf[kVec];
          Vec<T>::widen(vr[u], vf);
          l[g] += p;
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[g][i] += p * vf[i];
        }
        m[g] = mx;
      }
    }

    // the row groups of the warp, then the warps, in a fixed order
#pragma unroll
    for (int off = kLanesPerRow; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float l2 = __shfl_xor_sync(0xffffffffu, l[g], off);
        float a2[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          a2[i] = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        }
        merge_into<kVec>(m[g], l[g], acc[g], m2, l2, a2);
      }
    }
    if (g0 > 0) __syncthreads();   // the previous pass has read sM..sO
    if (rg == 0 && data) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (d0 == 0) {
          sM[warp][g] = m[g];
          sL[warp][g] = l[g];
        }
#pragma unroll
        for (int i = 0; i < kVec; ++i) sO[warp][g][d0 + i] = acc[g][i];
      }
    }
    __syncthreads();
    for (int e = tid; e < gn * D; e += kThreads) {
      const int g = e / D, d = e % D;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sM[w][g]);
      float o = 0.f, sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(sM[w][g] - mx);
        o += sO[w][g][d] * c;
        sum += sL[w][g] * c;
      }
      const int64_t h = out0 + g0 + g;
      po[h * D + d] = o;
      if (d == 0) {
        pl[h] = sum;
        pm[h] = mx;
      }
    }
  }
}

// The combine of the splits' partials ws = [o (S, BH, D) | l (S, BH) |
// m (S, BH)], one thread per output element (bh, d), in split order; the
// loads of kChunk splits are issued before the first is used.  Launched
// as a programmatic dependent of the split kernel, so its launch overlaps
// that kernel's run; it waits for the split kernel's writes before it
// reads.
__global__ void __launch_bounds__(kMergeThreads)
    fd_merge_kernel(const float* __restrict__ ws, float* __restrict__ o,
                    float* __restrict__ l, float* __restrict__ m, int S,
                    int BH, int D) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kMergeThreads +
                    threadIdx.x;
  if (e >= static_cast<int64_t>(BH) * D) return;
  const int64_t bh = e / D;
  const int d = static_cast<int>(e % D);
  const float* wl = ws + static_cast<int64_t>(S) * BH * D;
  const float* wm = wl + static_cast<int64_t>(S) * BH;
  float mx = kNegInf;
  for (int s0 = 0; s0 < S; s0 += kChunk) {
    float ms[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      ms[j] = s0 + j < S ? wm[static_cast<int64_t>(s0 + j) * BH + bh]
                         : kNegInf;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) mx = fmaxf(mx, ms[j]);
  }
  float acc = 0.f, sum = 0.f;
  for (int s0 = 0; s0 < S; s0 += kChunk) {
    float ms[kChunk], os[kChunk], ls[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int64_t i = static_cast<int64_t>(s0 + j) * BH + bh;
      const bool in = s0 + j < S;
      ms[j] = in ? wm[i] : 0.f;
      os[j] = in ? ws[i * D + d] : 0.f;
      ls[j] = in ? wl[i] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (s0 + j < S) {
        const float c = expf(ms[j] - mx);
        acc += os[j] * c;
        sum += ls[j] * c;
      }
    }
  }
  o[e] = acc;
  if (d == 0) {
    l[bh] = sum;
    m[bh] = mx;
  }
}

struct Args {
  const void *q, *kc, *vc, *pos;
  float *o, *l, *m, *ws;
  int B, Hkv, G, T, kv_offset, splits;
  float scale;
};

template <typename T, int D, int GC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.splits, a.Hkv, a.B);
  const int64_t bh = static_cast<int64_t>(a.B) * a.Hkv * a.G;
  float* po = a.splits > 1 ? a.ws : a.o;
  float* pl = a.splits > 1 ? a.ws + a.splits * bh * D : a.l;
  float* pm = a.splits > 1 ? pl + a.splits * bh : a.m;
  fd_split_kernel<T, D, GC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kc),
      static_cast<const T*>(a.vc), static_cast<const int32_t*>(a.pos), po,
      pl, pm, a.Hkv, a.G, a.T, a.kv_offset, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const int64_t n = bh * D;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((n + kMergeThreads - 1) /
                                           kMergeThreads));
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fd_merge_kernel,
                            static_cast<const float*>(a.ws), a.o, a.l, a.m,
                            a.splits, static_cast<int>(bh), D);
}

template <typename T, int D>
cudaError_t launch_g(const Args& a, cudaStream_t stream) {
  switch (a.G) {
    case 1: return launch<T, D, 1>(a, stream);
    case 2: return launch<T, D, 2>(a, stream);
    case 3: return launch<T, D, 3>(a, stream);
    default: return launch<T, D, kMaxHeads>(a, stream);
  }
}

template <typename T>
cudaError_t launch_d(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_g<T, 16>(a, stream);
    case 32: return launch_g<T, 32>(a, stream);
    case 64: return launch_g<T, 64>(a, stream);
    case 112: return launch_g<T, 112>(a, stream);   // zamba2's shared block
    case 128: return launch_g<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// q: (B, Hkv * G, D); k_cache, v_cache: (B, T, Hkv, D), fp32 (dtype 0) or
// bf16 (dtype 1), 16-byte aligned; pos: one int32; o: (B, H, D), l, m:
// (B, H) fp32; ws: splits * B * H * (D + 2) fp32 when splits > 1 (unused
// otherwise).  All contiguous on `device`.  D is 16, 32, 64, 112 or 128,
// G * D <= 2048 and 1 <= splits <= 1024.  Returns the first launch error
// (cudaError_t, 0 on success).
int fd_partial(const void* q, const void* k_cache, const void* v_cache,
               const void* pos, void* o, void* l, void* m, void* ws,
               int dtype, int B, int Hkv, int G, int T, int D, int kv_offset,
               int splits, float scale, int device, void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || Hkv > 65535 || G < 1 || T < 1 ||
      G * D > 2048 || splits < 1 || splits > 1024 ||
      (splits > 1 && ws == nullptr) || !aligned16(q) ||
      !aligned16(k_cache) || !aligned16(v_cache)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, k_cache, v_cache, pos,
               static_cast<float*>(o), static_cast<float*>(l),
               static_cast<float*>(m), static_cast<float*>(ws),
               B, Hkv, G, T, kv_offset, splits, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch_d<float>(D, a, s); break;
    case 1: err = launch_d<__nv_bfloat16>(D, a, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* fd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
