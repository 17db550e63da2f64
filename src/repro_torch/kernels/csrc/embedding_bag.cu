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
//                  memory node; its Pallas body is _nmp_kernel).  One warp
//                  per bag in table-major order, several rows in flight a
//                  warp: see nmp_flat_kernel below.
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
// The NMP kernel keeps several rows in flight a warp.  Its first design
// (one block per table, whose 8 warps strode over the batch through
// pool_bag) was latency-bound, not bound by bytes: at RM1's first NMP
// launch on an H100 (B 64, T 320, P 80, D 128 fp32, 33 valid slots a bag)
// each of 2,560 warps pooled 8 bags one after another, one row load at a
// time, each waited for before the next was issued: a chain of about 265
// loads a warp (0.92 us each over the 0.244 ms launch), about 1.3 MB in
// flight across the card where 3.35 TB/s times the memory's latency asks
// for 2 MB or more, and 45% of the bytes bound.  So now:
//   - one warp per (t, b) bag, numbered t * B + b: a block's warps pool
//     bags of one table, the NMP node's (and the reference's (T, B) grid's)
//     order, and the grid has B * T warps (20,480 there) instead of 8 T;
//   - each 32-slot chunk's indices come in one coalesced load, the next
//     chunk's issued before this chunk's rows, and a ballot of the valid
//     slots drives the warp: it takes them K at a time in slot order,
//     issues all K row loads (16 bytes a lane of fp32, 8 of bf16, through
//     the read-only path without L1 allocation: about 95% of rows are read
//     once a batch), then adds them in slot order.  A padding slot issues
//     no load and is never added; a chunk or a bag tail of padding costs
//     one ballot;
//   - the kernel is instantiated on the float4 columns a lane owns (1, 2,
//     4, 8 for D up to 128, 256, 512, 1024) and on K, chosen so that the
//     loads in flight take about 32 registers a lane (K = 8 at D <= 128
//     fp32 or D <= 256 bf16, 2 at D = 1024), so registers follow D and not
//     the widest D.  The scalar path (D % 4 != 0 or a misaligned table)
//     pools each bag with pool_bag, one row at a time.
// Hopper's TMA has no gather mode (gather4 is sm_100's), and a 512-byte
// cp.async.bulk per row into a shared-memory ring would cost an mbarrier
// round trip per row and shared memory the rows never need: they are added
// once, in registers, so the design spends its registers on loads in
// flight instead.
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

// A lane's share of one row chunk in the NMP kernel, loaded through the
// read-only path without L1 allocation (ld.global.nc.L1::no_allocate) and
// kept raw until it is added: four fp32 in 16 bytes, four bf16 in 8.
template <typename T>
struct RawChunk;
template <>
struct RawChunk<float> {
  using type = uint4;
  static __device__ __forceinline__ uint4 load(const float* p) {
    uint4 v;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
    return v;
  }
  static __device__ __forceinline__ float4 widen(uint4 v) {
    return make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                       __uint_as_float(v.z), __uint_as_float(v.w));
  }
};
template <>
struct RawChunk<__nv_bfloat16> {
  using type = uint2;
  static __device__ __forceinline__ uint2 load(const __nv_bfloat16* p) {
    uint2 v;
    asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
        : "=r"(v.x), "=r"(v.y)
        : "l"(p));
    return v;
  }
  // bf16 widens to fp32 exactly: its 16 bits are the fp32's high half
  static __device__ __forceinline__ float4 widen(uint2 v) {
    return make_float4(__uint_as_float(v.x << 16),
                       __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16),
                       __uint_as_float(v.y & 0xffff0000u));
  }
};

__device__ __forceinline__ int32_t load_index(const int32_t* p) {
  int32_t v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// The NMP kernel's schedule, from the shapes alone: kChunks float4 columns
// a lane (0 for the scalar path) and kK rows in flight, so that the loads
// in flight take about 32 registers a lane (4 a chunk of fp32, 2 of bf16),
// at least 2 rows and at most 8.
constexpr int nmp_chunks(int D, bool vec) {
  return !vec ? 0 : D <= 128 ? 1 : D <= 256 ? 2 : D <= 512 ? 4 : 8;
}
constexpr int nmp_rows_in_flight(int chunks, int itemsize) {
  return chunks == 0 ? 1
         : chunks * itemsize <= 4 ? 8
         : chunks * itemsize >= 16 ? 2
                                   : 32 / (chunks * itemsize);
}

// One warp per bag, bag = t * B + b (table-major: a block's warps pool
// bags of one table), writing out[b, t, :].  With kChunks > 0 lane l owns
// the float4 columns l, l + 32, ... < D / 4 and the warp takes the bag's
// valid slots kK at a time in slot order: all kK row loads first, then
// the adds, in slot order.  The indices of each 32-slot chunk come in one
// load (the next chunk's issued before this chunk's rows) and their
// ballot says which slots are valid, so padding issues no load.  With
// kChunks == 0 (D % 4 != 0 or a misaligned table) pool_bag pools the bag.
// The RM1 instantiation (float, 1, 8) is held to 64 registers, so 32
// warps stay resident on an SM.
template <typename T, int kChunks, int kK>
__global__ void __launch_bounds__(kThreads, kChunks == 1 ? 4 : 1)
    nmp_flat_kernel(const T* __restrict__ table, int64_t n_rows,
                    const int32_t* __restrict__ offsets,
                    const int32_t* __restrict__ idx,
                    float* __restrict__ out, int B, int T_, int P, int D) {
  const int lane = threadIdx.x % kWarp;
  const int64_t bag =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (bag >= static_cast<int64_t>(B) * T_) return;  // whole warp leaves
  const int t = static_cast<int>(bag / B);
  const int64_t bt = (bag % B) * T_ + t;             // (b, t) of (B, T)
  const int32_t* __restrict__ bag_idx = idx + bt * P;
  float* __restrict__ out_row = out + bt * D;
  const int64_t row_off = offsets[t];
  if constexpr (kChunks == 0) {
    pool_bag<T, float, false>(table, 0, n_rows - 1, row_off, bag_idx, P, D,
                              out_row, lane);
  } else {
    using Raw = typename RawChunk<T>::type;
    const int ncols = D >> 2;
    float4 acc[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    int next = lane < P ? load_index(bag_idx + lane) : -1;
    for (int p0 = 0; p0 < P; p0 += kWarp) {
      const int mine = next;
      const int p1 = p0 + kWarp + lane;
      next = p1 < P ? load_index(bag_idx + p1) : -1;
      // the chunk's valid slots; lanes past P hold -1.  Warp-uniform.
      unsigned live = __ballot_sync(0xffffffffu, mine >= 0);
      while (live != 0u) {
        Raw rows[kK][kChunks];
        int n = 0;
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          if (live != 0u) {
            const int src = __ffs(live) - 1;   // lowest valid slot left
            live &= live - 1u;
            const int32_t ix = __shfl_sync(0xffffffffu, mine, src);
            int64_t row = row_off + ix;
            row = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
            const T* rp = table + row * D;
#pragma unroll
            for (int c = 0; c < kChunks; ++c) {
              const int col = lane + c * kWarp;
              if (col < ncols) rows[k][c] = RawChunk<T>::load(rp + 4 * col);
            }
            n = k + 1;
          }
        }
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          if (k < n) {
#pragma unroll
            for (int c = 0; c < kChunks; ++c) {
              if (lane + c * kWarp < ncols) {
                const float4 x = RawChunk<T>::widen(rows[k][c]);
                acc[c].x += x.x;
                acc[c].y += x.y;
                acc[c].z += x.z;
                acc[c].w += x.w;
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = lane + c * kWarp;
      if (col < ncols) store4(out_row + 4 * col, acc[c]);
    }
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

// One warp per bag, kWarpsPerBlock bags a block.
dim3 bag_grid(int B, int T_) {
  const int64_t bags = static_cast<int64_t>(B) * T_;
  return dim3(static_cast<unsigned>(
      (bags + kWarpsPerBlock - 1) / kWarpsPerBlock));
}

template <typename T, int kChunks>
void launch_nmp(const T* tab, int64_t n_rows, const int32_t* off,
                const int32_t* ix, float* o, int B, int T_, int P, int D,
                cudaStream_t stream) {
  constexpr int kK = nmp_rows_in_flight(kChunks, sizeof(T));
  nmp_flat_kernel<T, kChunks, kK><<<bag_grid(B, T_), kThreads, 0, stream>>>(
      tab, n_rows, off, ix, o, B, T_, P, D);
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
    switch (nmp_chunks(D, vec)) {
      case 0:
        launch_nmp<T, 0>(tab, n_rows, off, ix, o, B, T_, P, D, stream);
        break;
      case 1:
        launch_nmp<T, 1>(tab, n_rows, off, ix, o, B, T_, P, D, stream);
        break;
      case 2:
        launch_nmp<T, 2>(tab, n_rows, off, ix, o, B, T_, P, D, stream);
        break;
      case 4:
        launch_nmp<T, 4>(tab, n_rows, off, ix, o, B, T_, P, D, stream);
        break;
      default:
        launch_nmp<T, 8>(tab, n_rows, off, ix, o, B, T_, P, D, stream);
    }
  } else {
    const dim3 grid = bag_grid(B, T_);
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
  const dim3 grid = bag_grid(B, T_);
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

// The schedule eb_nmp_flat launches with for these shapes: sched[0] the
// grid's blocks, [1] warps (bags) a block, [2] float4 columns a lane (0 on
// the scalar path), [3] rows in flight a warp.
int eb_nmp_schedule(int dtype, int B, int T, int D, int vec, int* sched) {
  if (B < 1 || T < 1 || D < 1 || D > kMaxD || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = nmp_chunks(D, vec != 0);
  sched[0] = static_cast<int>(bag_grid(B, T).x);
  sched[1] = kWarpsPerBlock;
  sched[2] = chunks;
  sched[3] = nmp_rows_in_flight(chunks, dtype == 0 ? 4 : 2);
  return 0;
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
