// Embedding-bag kernels for Hopper (sm_90a), bound to PyTorch by ctypes.
//
// Three kernels compute one function: pooled[b, t, :] = sum over p of
// table_t[idx[b, t, p], :], where idx < 0 marks a padding slot that is
// skipped.  Slots are added in ascending p order into an fp32 accumulator
// that starts at +0.0, with plain IEEE adds (the build uses no fast-math),
// so the fp32 result is bitwise equal to the slot-order reference whichever
// kernel pools a bag.
//
//   eb_fused_flat  replaces repro/kernels/embedding_bag.py
//                  embedding_bag_fused_flat (the CN-side bag a DDR memory
//                  node's raw rows are pooled with).  One warp per bag over
//                  a flat shard (sum_t R_t, D) addressed through per-table
//                  row offsets; writes fp32.
//   eb_nmp_flat    replaces repro/kernels/embedding_bag.py
//                  embedding_bag_nmp_flat (near-memory pooling on an NMP
//                  memory node).  Table-major like the NMP node: one block
//                  per table, whose warps stride over the batch.
//   eb_stacked     replaces repro/kernels/embedding_bag.py
//                  embedding_bag_1table, vmapped over a (T, R, D) table
//                  stack by embedding_bag (the table-sharded lookup of
//                  core/sharding.py).  One launch for the whole stack, one
//                  warp per (b, t) bag; writes the tables' dtype, the fp32
//                  sum rounded once to nearest-even.
//
// Bound: bytes.  Each valid slot reads one D-wide row; each bag reads P
// indices and writes D values: valid_slots*D*itemsize + B*T*P*4 +
// B*T*D*out_itemsize bytes over 3.35 TB/s, with no arithmetic worth
// counting.  The rows are gathered at random, so the design keeps every
// byte read once: a row streams from device memory into registers with
// 16-byte vector loads where the width allows, is added there, and never
// touches shared memory; there are no atomics (they would break the add
// order); each warp reads its bag's 32 next indices in one coalesced load
// and hands them out by shuffle.
//
// Row addresses are 64-bit: a full-width shard or stack holds more than
// 2^31 elements.  A row outside its table is clamped into it, which is what
// the reference's Pallas kernels read for such a row (their block index is
// clamped the same way): the flat kernels clamp into the flat table (row
// min(max(offsets[t] + idx, 0), n_rows - 1)), the stacked kernel into
// table t (row min(idx, R - 1) of table t).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr int kMaxD = 1024;                       // register accumulators
constexpr int kVecChunks = kMaxD / (4 * kWarp);   // float4 per lane
constexpr int kScalarChunks = kMaxD / kWarp;      // floats per lane

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive row elements as fp32: one 16-byte load for fp32, one
// 8-byte load for bf16.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &raw.x, sizeof(lo));
  memcpy(&hi, &raw.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Four fp32 sums stored as the output type: fp32 as they are, bf16 each
// rounded to nearest-even, in one 16-byte or 8-byte store.
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  memcpy(&raw.x, &lo, sizeof(lo));
  memcpy(&raw.y, &hi, sizeof(hi));
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One warp pools one bag: P slots in ascending order into fp32 registers,
// then writes the D-wide row of `out` as OutT.  Slot p reads table row
// row_off + idx[p], clamped into [row_lo, row_hi].  kVec needs D % 4 == 0
// and 16-byte (fp32) or 8-byte (bf16) aligned rows; lane l then owns the
// float4 columns l, l + 32, ...; otherwise it owns the elements l, l + 32,
// ...
template <typename T, typename OutT, bool kVec>
__device__ __forceinline__ void pool_bag(const T* __restrict__ table,
                                         int64_t row_lo, int64_t row_hi,
                                         int64_t row_off,
                                         const int32_t* __restrict__ bag_idx,
                                         int P, int D,
                                         OutT* __restrict__ out_row,
                                         int lane) {
  constexpr int kChunks = kVec ? kVecChunks : kScalarChunks;
  const int ncols = kVec ? (D >> 2) : D;
  float4 acc4[kVec ? kChunks : 1];
  float acc1[kVec ? 1 : kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if constexpr (kVec) {
      acc4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      acc1[c] = 0.f;
    }
  }
  for (int p0 = 0; p0 < P; p0 += kWarp) {
    const int mine = (p0 + lane < P) ? bag_idx[p0 + lane] : -1;
    const int n = min(kWarp, P - p0);
    for (int k = 0; k < n; ++k) {
      const int32_t ix = __shfl_sync(0xffffffffu, mine, k);
      if (ix < 0) continue;  // padding slot: predicated off, never added
      int64_t row = row_off + ix;
      row = row < row_lo ? row_lo : (row > row_hi ? row_hi : row);
      const T* src = table + row * D;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = lane + c * kWarp;
        if (col < ncols) {
          if constexpr (kVec) {
            const float4 x = load4(src + 4 * col);
            acc4[c].x += x.x;
            acc4[c].y += x.y;
            acc4[c].z += x.z;
            acc4[c].w += x.w;
          } else {
            acc1[c] += to_f32(src[col]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = lane + c * kWarp;
    if (col < ncols) {
      if constexpr (kVec) {
        store4(out_row + 4 * col, acc4[c]);
      } else {
        store1(out_row + col, acc1[c]);
      }
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    fused_flat_kernel(const T* __restrict__ table, int64_t n_rows,
                      const int32_t* __restrict__ offsets,
                      const int32_t* __restrict__ idx,
                      float* __restrict__ out, int B, int T_, int P, int D) {
  const int lane = threadIdx.x % kWarp;
  const int64_t bag =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (bag >= static_cast<int64_t>(B) * T_) return;  // whole warp leaves
  const int t = static_cast<int>(bag % T_);
  pool_bag<T, float, kVec>(table, 0, n_rows - 1, offsets[t], idx + bag * P,
                           P, D, out + bag * D, lane);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    nmp_flat_kernel(const T* __restrict__ table, int64_t n_rows,
                    const int32_t* __restrict__ offsets,
                    const int32_t* __restrict__ idx,
                    float* __restrict__ out, int B, int T_, int P, int D) {
  const int lane = threadIdx.x % kWarp;
  const int t = blockIdx.x;
  const int64_t row_off = offsets[t];
  for (int b = threadIdx.x / kWarp; b < B; b += kWarpsPerBlock) {
    const int64_t bag = static_cast<int64_t>(b) * T_ + t;
    pool_bag<T, float, kVec>(table, 0, n_rows - 1, row_off, idx + bag * P,
                             P, D, out + bag * D, lane);
  }
}

// The (T, R, D) stack in one launch: bag = b * T + t, as the (B, T, P)
// indices and the (B, T, D) output lie.  Table t starts at row t * R, and
// its rows past the end read its row R - 1.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    stacked_kernel(const T* __restrict__ tables, int64_t R,
                   const int32_t* __restrict__ idx, T* __restrict__ out,
                   int B, int T_, int P, int D) {
  const int lane = threadIdx.x % kWarp;
  const int64_t bag =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (bag >= static_cast<int64_t>(B) * T_) return;  // whole warp leaves
  const int64_t first = (bag % T_) * R;
  pool_bag<T, T, kVec>(tables, first, first + R - 1, first, idx + bag * P, P,
                       D, out + bag * D, lane);
}

template <typename T>
cudaError_t launch(bool nmp, const void* table, int64_t n_rows,
                   const void* offsets, const void* idx, void* out, int B,
                   int T_, int P, int D, bool vec, cudaStream_t stream) {
  const T* tab = static_cast<const T*>(table);
  const int32_t* off = static_cast<const int32_t*>(offsets);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  float* o = static_cast<float*>(out);
  if (nmp) {
    const dim3 grid(T_);
    if (vec) {
      nmp_flat_kernel<T, true><<<grid, kThreads, 0, stream>>>(
          tab, n_rows, off, ix, o, B, T_, P, D);
    } else {
      nmp_flat_kernel<T, false><<<grid, kThreads, 0, stream>>>(
          tab, n_rows, off, ix, o, B, T_, P, D);
    }
  } else {
    const int64_t bags = static_cast<int64_t>(B) * T_;
    const dim3 grid(static_cast<unsigned>(
        (bags + kWarpsPerBlock - 1) / kWarpsPerBlock));
    if (vec) {
      fused_flat_kernel<T, true><<<grid, kThreads, 0, stream>>>(
          tab, n_rows, off, ix, o, B, T_, P, D);
    } else {
      fused_flat_kernel<T, false><<<grid, kThreads, 0, stream>>>(
          tab, n_rows, off, ix, o, B, T_, P, D);
    }
  }
  return cudaGetLastError();
}

int dispatch(bool nmp, const void* table, int dtype, long long n_rows,
             const void* offsets, const void* idx, void* out, int B, int T_,
             int P, int D, int vec, int device, void* stream) {
  if (B < 1 || T_ < 1 || P < 0 || D < 1 || D > kMaxD || n_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch<float>(nmp, table, n_rows, offsets, idx, out, B, T_, P, D,
                          vec != 0, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(nmp, table, n_rows, offsets, idx, out, B,
                                  T_, P, D, vec != 0, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

template <typename T>
cudaError_t launch_stacked(const void* tables, int64_t R, const void* idx,
                           void* out, int B, int T_, int P, int D, bool vec,
                           cudaStream_t stream) {
  const T* tab = static_cast<const T*>(tables);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  T* o = static_cast<T*>(out);
  const int64_t bags = static_cast<int64_t>(B) * T_;
  const dim3 grid(static_cast<unsigned>(
      (bags + kWarpsPerBlock - 1) / kWarpsPerBlock));
  if (vec) {
    stacked_kernel<T, true><<<grid, kThreads, 0, stream>>>(tab, R, ix, o, B,
                                                           T_, P, D);
  } else {
    stacked_kernel<T, false><<<grid, kThreads, 0, stream>>>(tab, R, ix, o, B,
                                                            T_, P, D);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// table: (n_rows, D) fp32 (dtype 0) or bf16 (dtype 1); offsets: (T,) int32;
// idx: (B, T, P) int32, -1 padded; out: (B, T, D) fp32.  All contiguous on
// `device`.  Returns the launch's cudaError_t (0 on success).
int eb_fused_flat(const void* table, int dtype, long long n_rows,
                  const void* offsets, const void* idx, void* out, int B,
                  int T, int P, int D, int vec, int device, void* stream) {
  return dispatch(false, table, dtype, n_rows, offsets, idx, out, B, T, P, D,
                  vec, device, stream);
}

int eb_nmp_flat(const void* table, int dtype, long long n_rows,
                const void* offsets, const void* idx, void* out, int B, int T,
                int P, int D, int vec, int device, void* stream) {
  return dispatch(true, table, dtype, n_rows, offsets, idx, out, B, T, P, D,
                  vec, device, stream);
}

// tables: (T, R, D) fp32 (dtype 0) or bf16 (dtype 1); idx: (B, T, P)
// int32, -1 padded; out: (B, T, D) in the tables' dtype.  All contiguous on
// `device`.  Returns the launch's cudaError_t (0 on success).
int eb_stacked(const void* tables, int dtype, long long R, const void* idx,
               void* out, int B, int T, int P, int D, int vec, int device,
               void* stream) {
  if (B < 1 || T < 1 || P < 0 || D < 1 || D > kMaxD || R < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch_stacked<float>(tables, R, idx, out, B, T, P, D, vec != 0,
                                  s);
      break;
    case 1:
      err = launch_stacked<__nv_bfloat16>(tables, R, idx, out, B, T, P, D,
                                          vec != 0, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* eb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
