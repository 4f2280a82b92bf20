// Fused gather + weighted CSR segment-sum for Hopper (sm_90a).
//
//   out[r, :] = sum_{e = row_ptr[r]}^{row_ptr[r+1]-1} (w ? w[e] : 1) * x[idx ? idx[e] : e, :]
//
// Replaces two Pallas TPU kernels of tgp_tpu/ops/pallas/segment_spmm.py:
//   * _grouped_kernel_w (K1), run by spmm_csr -> _gather_kernel_pass: the
//     weighted SpMM over a receiver-sorted static CSR (idx = senders);
//   * _grouped_kernel (K2), run by segment_sum_sorted: the unweighted
//     segment-sum of receiver-sorted messages (idx = null, w = null).
//
// What bounds it on an H100: bytes.  It does 2 flops per gathered element,
// far below the card's ~295 flop/byte balance point.  The least traffic is
// idx + w + row_ptr + one read of x + one write of out; the gathered rows
// themselves (E*F elements) are served from L2 when x fits in its 50 MB.
//
// What the design does about it: the TPU kernel gathered x[idx] into an
// [E, F] array in device memory and summed it with a one-hot matmul per
// edge chunk.  Here one warp owns a slice of at most S edges of one output
// row, loads its edge indices and weights once (one per lane), and gathers
// x[idx_e] straight into f32 registers with 16-byte vector loads, so no
// [E, F] rows and no padding of E ever reach device memory.  Output rows
// are written once, in x's dtype.  Rows longer than S edges (the padding
// edges make row 0 one) are split across warps, so no warp walks more than
// S edges.  When a row is narrower than 32 lanes' worth of vectors, the
// warp splits into lane groups that walk different edges and meet by
// shuffles at the end.
//
// Plain C interface (bound with ctypes); the caller allocates `out`, passes
// PyTorch's current stream, and reads the returned cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC consecutive elements, aligned so one load or store moves them all.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Sum of (w ? w[e] : 1) * x[idx ? idx[e] : e, :] over edges [start, end),
// written to `out_row` in T, or added in f32 to `acc_row` with atomics.
//
// The warp splits into kWarp / G lane groups of G lanes; group g takes
// edges g, g + groups, ... of each 32-edge batch, lane `sub` of a group owns
// columns [c * VEC, (c + 1) * VEC) of the current G * VEC-wide column tile,
// and the groups meet by shuffles.  All loop bounds are uniform across the
// warp, so every shuffle runs with the full mask.
template <typename T, int VEC>
__device__ __forceinline__ void slice_sum(
    const T* __restrict__ x, const int32_t* __restrict__ idx,
    const float* __restrict__ w, int start, int end, int F, int G,
    T* __restrict__ out_row, float* __restrict__ acc_row) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int groups = kWarp / G;
  const int grp = lane / G;
  const int sub = lane - grp * G;
  const int chunks = F / VEC;
  for (int c0 = 0; c0 < chunks; c0 += G) {
    const int c = c0 + sub;
    const bool col_ok = c < chunks;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

    for (int base = start; base < end; base += kWarp) {
      const int e = base + lane;
      int my_src = 0;
      float my_w = 0.f;
      if (e < end) {
        my_src = idx != nullptr ? idx[e] : e;
        my_w = w != nullptr ? w[e] : 1.f;
      }
      const int n = min(kWarp, end - base);
#pragma unroll 4
      for (int j0 = 0; j0 < n; j0 += groups) {
        const int j = j0 + grp;
        const int src = __shfl_sync(kFull, my_src, j & (kWarp - 1));
        const float we = __shfl_sync(kFull, my_w, j & (kWarp - 1));
        if (j < n && col_ok) {
          const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(
              x + static_cast<size_t>(src) * F + static_cast<size_t>(c) * VEC);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = fmaf(we, to_float(p.v[k]), acc[k]);
        }
      }
    }

    for (int off = G; off < kWarp; off <<= 1) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += __shfl_xor_sync(kFull, acc[k], off);
    }
    if (grp == 0 && col_ok) {
      if (acc_row == nullptr) {
        Pack<T, VEC> p;
#pragma unroll
        for (int k = 0; k < VEC; ++k) p.v[k] = from_float<T>(acc[k]);
        *reinterpret_cast<Pack<T, VEC>*>(out_row + static_cast<size_t>(c) * VEC) = p;
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) atomicAdd(acc_row + c * VEC + k, acc[k]);
      }
    }
  }
}

// Work split: warp r < num_rows is row r's primary and sums its first S
// edges; warp num_rows + k is the tail warp of edge chunk k = [k*S, (k+1)*S)
// and sums the edges of that chunk that lie more than S past the start of
// their row.  A chunk holds the tail of at most one row (any row starting
// inside it keeps its first S edges for its primary), so no row walks more
// than S edges in one warp, whatever its length: the zero-weight padding
// edges at the head of row 0 are one such long row.
//
// A row of at most S edges is written by its primary.  For a longer row
// the primary and every tail warp add their f32 partial sums into the
// row's slot of `acc` (at the row's first tail chunk) with atomics, count
// themselves on the row's counter, and the last to arrive converts the
// slot into the row of `out`.  The order of those f32 additions varies
// from run to run.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    csr_spmm_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                    const float* __restrict__ w,
                    const int32_t* __restrict__ row_ptr,
                    float* __restrict__ acc, int32_t* __restrict__ counters,
                    T* __restrict__ out, int num_rows, int F, int G, int S) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  int row, start, end;
  if (warp < num_rows) {
    row = warp;
    start = row_ptr[row];
    end = row_ptr[row + 1];
    if (end - start <= S) {
      slice_sum<T, VEC>(x, idx, w, start, end, F, G,
                        out + static_cast<size_t>(row) * F, nullptr);
      return;
    }
    end = start + S;
  } else {
    const int p = (warp - num_rows) * S;
    if (p >= row_ptr[num_rows]) return;
    int lo = 0, hi = num_rows - 1;  // the row holding edge p
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (row_ptr[mid] <= p) lo = mid; else hi = mid - 1;
    }
    row = lo;
    start = max(p, row_ptr[row] + S);
    end = min(p + S, row_ptr[row + 1]);
    if (start >= end) return;  // no tail edges in this chunk
  }
  const int rs = row_ptr[row], re = row_ptr[row + 1];
  const int k_first = (rs + S) / S, k_last = (re - 1) / S;
  float* acc_row = acc + static_cast<size_t>(k_first) * F;
  slice_sum<T, VEC>(x, idx, w, start, end, F, G, nullptr, acc_row);

  __threadfence();
  __syncwarp();
  int prev = 0;
  if (lane == 0) prev = atomicAdd(counters + k_first, 1);
  prev = __shfl_sync(kFull, prev, 0);
  if (prev != k_last - k_first + 1) return;  // not the last of 1 + tails
  __threadfence();
  T* out_row = out + static_cast<size_t>(row) * F;
  for (int col = lane; col < F; col += kWarp)
    out_row[col] = from_float<T>(__ldcg(acc_row + col));
}

// Widest vector (at most 16 bytes) that divides F and both base pointers'
// alignment.
template <typename T>
int pick_vec(const void* x, const void* out, int F) {
  for (int vec = 16 / static_cast<int>(sizeof(T)); vec > 1; vec /= 2) {
    const uintptr_t bytes = static_cast<uintptr_t>(vec) * sizeof(T);
    if (F % vec == 0 && reinterpret_cast<uintptr_t>(x) % bytes == 0 &&
        reinterpret_cast<uintptr_t>(out) % bytes == 0)
      return vec;
  }
  return 1;
}

struct Args {
  const void* x;
  const void* idx;
  const void* w;
  const void* row_ptr;
  void* acc;
  void* counters;
  void* out;
  int num_rows, F, S, n_chunks;
  cudaStream_t stream;
};

template <typename T, int VEC>
void launch(const Args& a) {
  const int chunks = a.F / VEC;
  int G = 1;
  while (G < chunks && G < kWarp) G *= 2;
  const long long warps = static_cast<long long>(a.num_rows) + a.n_chunks;
  const int blocks = static_cast<int>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  csr_spmm_kernel<T, VEC><<<blocks, kWarp * kWarpsPerBlock, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const int32_t*>(a.idx),
      static_cast<const float*>(a.w), static_cast<const int32_t*>(a.row_ptr),
      static_cast<float*>(a.acc), static_cast<int32_t*>(a.counters),
      static_cast<T*>(a.out), a.num_rows, a.F, G, a.S);
}

template <typename T>
void dispatch(const Args& a) {
  switch (pick_vec<T>(a.x, a.out, a.F)) {
    case 8:
      launch<T, 8>(a);
      break;
    case 4:
      launch<T, 4>(a);
      break;
    case 2:
      launch<T, 2>(a);
      break;
    default:
      launch<T, 1>(a);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out).  idx and w may be null.
// S: edges per warp; n_chunks = ceil(E / S) for the E edges that row_ptr
// indexes.  acc: f32 [n_chunks, F] and counters: int32 [n_chunks], both
// zeroed here on `stream` before the launch.
// Returns the first CUDA error (0 = cudaSuccess).
int tgp_csr_spmm(const void* x, const void* idx, const void* w,
                 const void* row_ptr, void* acc, void* counters, void* out,
                 int num_rows, int F, int S, int n_chunks, int dtype,
                 void* stream) {
  if (num_rows <= 0 || F <= 0 || S <= 0 || n_chunks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, idx, w, row_ptr, acc, counters, out, num_rows, F, S,
               n_chunks, static_cast<cudaStream_t>(stream)};
  if (n_chunks > 0) {
    const size_t n = static_cast<size_t>(n_chunks);
    cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(float) * n * F, a.stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(counters, 0, sizeof(int32_t) * n, a.stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dtype == 0) {
    dispatch<float>(a);
  } else if (dtype == 1) {
    dispatch<__nv_bfloat16>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tgp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
