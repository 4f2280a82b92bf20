// Segment sum over long runs of rows for Hopper (sm_90a): K4's long-segment
// mode,
//
//   out[r, :] = sum_{e = row_ptr[r]}^{row_ptr[r+1]-1} [keep[src_e]] * x[src_e, :],
//   src_e = perm ? perm[e] : e   (clamped to [0, n_x)),
//
// f32 sums, out in x's type (f32 or bf16), rows with no edges written as 0,
// no position past row_ptr[num_rows] read.  A row whose keep flag is 0 is
// skipped, not multiplied by 0, so a NaN or inf in it never reaches a sum.
//
// Replaces the Pallas TPU kernel _kernel / sorted_segment_sum_pallas of
// tgp_tpu/ops/pallas/segment_spmm.py (K4) where its segments are long: the
// sparse readout's sum of each graph's rows (one graph of 65,536 pooled rows
// a request, or a batch's graphs of a few hundred rows each).  perm and keep
// are the readout's sort order and mask, so the readout gathers its rows
// here instead of writing a sorted, masked copy first.  The TPU kernel
// walked a 256-row output block's edge chunks in order on one core, summing
// them with one-hot matmuls; here the edge range is cut into chunks that
// all run at once.
//
// What bounds it on an H100: bytes.  One add per element read; the least
// traffic is one read of each kept row (plus perm, keep and row_ptr) and
// one write of out.  What the design does about it:
//   * Fill the card.  Positions [row_ptr[0], row_ptr[num_rows]) are cut
//     into chunks of C positions, one block of 256 threads a chunk.  C is
//     set by (the positions' count, F and the vector width) alone, never by
//     the card, so the bits are the same on any card: the smallest
//     L * 8 * 2^m (L: the block's edge lanes) that leaves at most 256
//     chunks, about one wave at two blocks an SM.  At the readout's shape
//     (65,536 f32 rows of 128) C = 256, 256 blocks of 128 KB each.
//   * Keep many loads in flight.  A thread owns one 16-byte column vector
//     of a row (G lanes cover a row, up to 32) and takes the chunk's
//     positions j, j + L, ... (L = 256 / G edge lanes), 8 at a time: the 8
//     indices, then the 8 keep flags, then the 8 kept rows' vectors are
//     loaded before the first add.  The L partial sums meet in a fixed tree
//     in shared memory.
//   * Segments.  A chunk sums each row it holds in turn (rows in order,
//     the next row with edges found by a 32-way search of row_ptr).  A row
//     that lies inside the chunk is written to out; a row that crosses the
//     chunk's ends leaves its piece in an f32 slot.
//   * Finish without one serial warp.  The pieces of a split row are added
//     in two levels: chunks fall in groups of 32, and the last of a row's
//     chunks in a group to arrive (an integer counter) adds the group's
//     pieces in chunk order with the whole block (32 floats a thread in
//     flight, the same fixed tree); a row within one group is then written,
//     else the group's sum goes to a slot and the last group to arrive on
//     the row's second counter adds the (at most 8) group sums in order.
// Why the sum order is fixed: every f32 addition is in an order set by the
// layout (a thread's positions in order, the tree, the pieces in chunk
// order, the groups in order); only which block does the last addition
// varies, and it adds the same numbers in the same order.  No float
// atomics.  The counters reset themselves (the last arriver sets its
// counter back to 0), so the caller keeps one zeroed counter buffer per
// stream and no memset runs per call.
//
// Plain C interface (bound with ctypes); the caller allocates `out`, the
// slots and the counters, passes PyTorch's current stream, and reads the
// returned cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kUnroll = 8;         // row loads a thread has in flight
constexpr int kGroup = 32;         // chunks a first-level group
constexpr int kMaxChunks = 256;    // about one wave at two blocks an SM
static_assert(kMaxChunks <= kGroup * kGroup, "a row has <= 32 group sums");
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

// What every block reads.  part: f32 slots [n_chunks, 2, F] (sub-slot 0:
// the chunk's piece of a row that started in an earlier chunk; 1: the
// piece of the row that starts in the chunk and goes on past it, later its
// group's sum); counters: int32 [3 * n_chunks] (2 a chunk for the first
// level, indexed like the slots; then 1 a chunk for the second, indexed by
// the chunk a row starts in), zero before and after a launch.
struct Seg {
  const int32_t* perm;
  const uint8_t* keep;
  const int32_t* row_ptr;
  float* part;
  int32_t* counters;
  int n_x, num_rows, F, C, n_chunks, G, cols;
};

// Smallest r in [lo, hi] with rp[r] > v, given rp[hi] > v: a 32-way search
// by one warp (each round one load a lane and a ballot).
__device__ __forceinline__ int first_above(const int32_t* __restrict__ rp,
                                           int lo, int hi, int v) {
  const int lane = threadIdx.x & (kWarp - 1);
  while (lo < hi) {
    const int q =
        lo + static_cast<int>((static_cast<long long>(hi - lo) * lane) >> 5);
    const unsigned below = __ballot_sync(kFull, rp[q] <= v);
    if (below == 0) return lo;
    const int j = 31 - __clz(below);  // last probe at or below v
    const int qj = __shfl_sync(kFull, q, j);
    const int qn = __shfl_sync(kFull, q, (j + 1) & (kWarp - 1));
    lo = qj + 1;
    if (j < kWarp - 1) hi = qn;
  }
  return lo;
}

// The L = kThreads / G partial sums of each column lane meet in a fixed
// tree in shared memory (red: VEC * kThreads floats); the sum lands in the
// threads of edge lane 0.
template <int VEC>
__device__ __forceinline__ void block_tree(float (&acc)[VEC], float* red,
                                           int j, int L, int G) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < VEC; ++k) red[k * kThreads + t] = acc[k];
  __syncthreads();
  for (int h = L / 2; h > 0; h >>= 1) {
    if (j < h) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        red[k * kThreads + t] += red[k * kThreads + t + h * G];
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = red[k * kThreads + t];
}

// Count this block's piece on `counter` (after its slot stores); true, in
// every thread, for the last of `expected` arrivals, which then resets the
// counter and may read every piece.
__device__ __forceinline__ bool block_arrive(int32_t* counter, int expected,
                                             int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(counter, 1) == expected - 1;
    if (last) *counter = 0;
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// acc += the kept rows of positions [lo, hi), column vector c: edge lane j
// takes positions lo + j, + L, ..., kUnroll at a time.
template <typename T, int VEC>
__device__ __forceinline__ void rows_sum(const T* __restrict__ x,
                                         const Seg& s, int lo, int hi, int c,
                                         int j, int L, float (&acc)[VEC]) {
  if (c >= s.cols) return;
  for (int e0 = lo + j; e0 < hi; e0 += L * kUnroll) {
    int src[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * L;
      src[u] = -1;
      if (e < hi) src[u] = min(max(s.perm != nullptr ? s.perm[e] : e, 0), s.n_x - 1);
    }
    if (s.keep != nullptr) {
      bool kept[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) kept[u] = src[u] >= 0 && s.keep[src[u]] != 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (!kept[u]) src[u] = -1;
    }
    Pack<T, VEC> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (src[u] >= 0)
        v[u] = *reinterpret_cast<const Pack<T, VEC>*>(
            x + static_cast<size_t>(src[u]) * s.F + static_cast<size_t>(c) * VEC);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (src[u] >= 0)
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += to_float(v[u].v[k]);
  }
}

// f32 sub-slot `slot` of part, column vector c (read through L2: other
// SMs wrote it).
template <int VEC>
__device__ __forceinline__ void slot_load(const Seg& s, int slot, int c,
                                          float (&v)[VEC]) {
  const float* at = s.part + static_cast<size_t>(slot) * s.F + static_cast<size_t>(c) * VEC;
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 f = __ldcg(reinterpret_cast<const float4*>(at + k));
      v[k] = f.x;
      v[k + 1] = f.y;
      v[k + 2] = f.z;
      v[k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = __ldcg(at + k);
  }
}

// acc += sub-slots slot_of(0 .. n-1), column vector c, in that order per
// edge lane (lane j takes pieces j, j + L, ...; 32 floats in flight).
template <int VEC, typename SlotOf>
__device__ __forceinline__ void slots_sum(const Seg& s, int n, SlotOf slot_of,
                                          int c, int j, int L,
                                          float (&acc)[VEC]) {
  constexpr int U = VEC >= 8 ? 4 : kUnroll;
  if (c >= s.cols) return;
  for (int i0 = j; i0 < n; i0 += L * U) {
    float v[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u * L < n) slot_load<VEC>(s, slot_of(i0 + u * L), c, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u * L < n)
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += v[u][k];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_out(T* __restrict__ out_row, int c,
                                          const float (&acc)[VEC]) {
  Pack<T, VEC> p;
#pragma unroll
  for (int k = 0; k < VEC; ++k) p.v[k] = from_float<T>(acc[k]);
  *reinterpret_cast<Pack<T, VEC>*>(out_row + static_cast<size_t>(c) * VEC) = p;
}

template <int VEC>
__device__ __forceinline__ void store_slot(const Seg& s, int slot, int c,
                                           const float (&acc)[VEC]) {
  float* at = s.part + static_cast<size_t>(slot) * s.F + static_cast<size_t>(c) * VEC;
#pragma unroll
  for (int k = 0; k < VEC; ++k) at[k] = acc[k];
}

// Row r (positions [rs, re), chunks kf..kl) after chunk k stored its piece:
// the two-level finish (see the head of the file).
template <typename T, int VEC>
__device__ void finish_row(T* __restrict__ out, const Seg& s, int r, int kf,
                           int kl, int k, float* red, int* flag, int j, int q,
                           int L, int tiles) {
  const int g = k / kGroup;
  const int a = max(kf, g * kGroup), b = min(kl, g * kGroup + kGroup - 1);
  const int first = 2 * a + (a == kf ? 1 : 0);  // the group's first piece
  if (!block_arrive(s.counters + first, b - a + 1, flag)) return;
  const int gf = kf / kGroup, gl = kl / kGroup;
  T* out_row = out + static_cast<size_t>(r) * s.F;
  for (int tile = 0; tile < tiles; ++tile) {
    const int c = tile * s.G + q;
    float acc[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[u] = 0.f;
    slots_sum<VEC>(s, b - a + 1,
                   [&](int i) { return i == 0 ? first : 2 * (a + i); }, c, j,
                   L, acc);
    block_tree<VEC>(acc, red, j, L, s.G);
    if (j == 0 && c < s.cols) {
      if (gf == gl)
        store_out<T, VEC>(out_row, c, acc);
      else
        store_slot<VEC>(s, first, c, acc);  // the group's sum
    }
  }
  if (gf == gl) return;
  if (!block_arrive(s.counters + 2 * s.n_chunks + kf, gl - gf + 1, flag)) return;
  for (int tile = 0; tile < tiles; ++tile) {
    const int c = tile * s.G + q;
    float acc[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[u] = 0.f;
    // group gf's sum sits in the row's first piece's slot, each later
    // group's in the slot of its first chunk (a row started earlier)
    slots_sum<VEC>(s, gl - gf + 1,
                   [&](int i) { return i == 0 ? 2 * kf + 1 : 2 * (gf + i) * kGroup; },
                   c, j, L, acc);
    block_tree<VEC>(acc, red, j, L, s.G);
    if (j == 0 && c < s.cols) store_out<T, VEC>(out_row, c, acc);
  }
}

// Block k: zero its share of the rows with no edges, then sum chunk k,
// positions [row_ptr[0] + k*C, + C), row by row.
// Two blocks an SM, but one for bf16 rows of 16 bytes a lane (their 8
// loads in flight and 8 f32 sums spill at two).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, VEC >= 8 ? 1 : 2)
    segment_reduce_kernel(const T* __restrict__ x, T* __restrict__ out,
                          Seg s) {
  __shared__ float red[VEC * kThreads];
  __shared__ int sh_row, sh_flag;
  const int t = threadIdx.x, G = s.G, q = t % G, j = t / G, L = kThreads / G;
  const int k = blockIdx.x;
  const int32_t* rp = s.row_ptr;

  // every row of out is written once: rows with edges by their chunks,
  // rows [k*per, (k+1)*per) without edges here, a warp a row
  const int per = (s.num_rows + s.n_chunks - 1) / s.n_chunks;
  const long long first_row = static_cast<long long>(k) * per;
  if (first_row < s.num_rows) {
    const int r1 = min(static_cast<int>(first_row) + per, s.num_rows);
    for (int r = static_cast<int>(first_row) + t / kWarp; r < r1; r += kThreads / kWarp)
      if (rp[r] == rp[r + 1])
        for (int col = t % kWarp; col < s.F; col += kWarp)
          out[static_cast<size_t>(r) * s.F + col] = from_float<T>(0.f);
  }

  const int base = rp[0], end = rp[s.num_rows];
  const int p0 = base + k * s.C;
  if (p0 >= end) return;
  const int p1 = min(p0 + s.C, end);
  if (t < kWarp) {
    const int r = first_above(rp, 0, s.num_rows, p0) - 1;
    if (t == 0) sh_row = r;
  }
  __syncthreads();
  int r = sh_row;
  const int tiles = (s.cols + G - 1) / G;
  for (;;) {
    const int rs = rp[r], re = rp[r + 1];
    const int lo = max(rs, p0), hi = min(re, p1);
    const bool whole = rs >= p0 && re <= p1;
    const int slot = 2 * k + (rs < p0 ? 0 : 1);
    for (int tile = 0; tile < tiles; ++tile) {
      const int c = tile * G + q;
      float acc[VEC];
#pragma unroll
      for (int u = 0; u < VEC; ++u) acc[u] = 0.f;
      rows_sum<T, VEC>(x, s, lo, hi, c, j, L, acc);
      block_tree<VEC>(acc, red, j, L, G);
      if (j == 0 && c < s.cols) {
        if (whole)
          store_out<T, VEC>(out + static_cast<size_t>(r) * s.F, c, acc);
        else
          store_slot<VEC>(s, slot, c, acc);
      }
    }
    if (!whole)
      finish_row<T, VEC>(out, s, r, (rs - base) / s.C, (re - 1 - base) / s.C,
                         k, red, &sh_flag, j, q, L, tiles);
    if (re >= p1) break;
    // the next row with edges starts at re (a row after r has some: re <
    // row_ptr[num_rows])
    if (rp[r + 2] > re) {
      ++r;
    } else {
      if (t < kWarp) {
        const int nr = first_above(rp, r + 2, s.num_rows, re) - 1;
        if (t == 0) sh_row = nr;
      }
      __syncthreads();
      r = sh_row;  // rewritten only after the next block_tree's barriers
    }
  }
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

struct Plan {
  int vec, cols, G, C, n_chunks;
};

// The chunking, from (positions, F, vector width) alone.
Plan plan_for(int vec, int n_edges, int F) {
  Plan p{};
  p.vec = vec;
  p.cols = F / vec;
  p.G = 1;
  while (p.G < p.cols && p.G < kWarp) p.G *= 2;
  long long C = static_cast<long long>(kThreads / p.G) * kUnroll;
  while ((n_edges + C - 1) / C > kMaxChunks) C *= 2;
  p.C = static_cast<int>(C);
  p.n_chunks = static_cast<int>(n_edges > 0 ? (n_edges + C - 1) / C : 1);
  return p;
}

Plan plan_of(const void* x, const void* out, int n_edges, int F, int dtype) {
  const int vec = dtype == 0 ? pick_vec<float>(x, out, F)
                             : pick_vec<__nv_bfloat16>(x, out, F);
  return plan_for(vec, n_edges, F);
}

template <typename T, int VEC>
void launch(const void* x, void* out, const Seg& s, cudaStream_t stream) {
  segment_reduce_kernel<T, VEC><<<s.n_chunks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), s);
}

template <typename T>
void dispatch(const void* x, void* out, const Seg& s, int vec,
              cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) return launch<T, 8>(x, out, s, stream);
  }
  switch (vec) {
    case 4: launch<T, 4>(x, out, s, stream); break;
    case 2: launch<T, 2>(x, out, s, stream); break;
    default: launch<T, 1>(x, out, s, stream);
  }
}

}  // namespace

extern "C" {

// Chunks of one call: part must hold 2 * chunks * F floats and counters
// 3 * chunks int32 zeros.  n_edges: the positions' count (perm's length,
// or x's rows without perm), at least row_ptr[num_rows].
int tgp_segment_reduce_chunks(const void* x, const void* out, int n_edges,
                              int F, int dtype) {
  return plan_of(x, out, n_edges, F, dtype).n_chunks;
}

// dtype: 0 = float32, 1 = bfloat16 (x and out).  perm (int32 [n_edges])
// and keep (uint8 [n_x]) may be null.  Returns the first CUDA error
// (0 = cudaSuccess).
int tgp_segment_reduce(const void* x, const void* perm, const void* keep,
                       const void* row_ptr, void* part, void* counters,
                       void* out, int n_x, int n_edges, int num_rows, int F,
                       int n_chunks, int dtype, void* stream) {
  if (num_rows <= 0 || F <= 0 || n_x <= 0 || n_edges < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_of(x, out, n_edges, F, dtype);
  if (n_chunks != p.n_chunks) return static_cast<int>(cudaErrorInvalidValue);
  const Seg s{static_cast<const int32_t*>(perm), static_cast<const uint8_t*>(keep),
              static_cast<const int32_t*>(row_ptr), static_cast<float*>(part),
              static_cast<int32_t*>(counters), n_x, num_rows, F, p.C,
              p.n_chunks, p.G, p.cols};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dispatch<float>(x, out, s, p.vec, st);
  else
    dispatch<__nv_bfloat16>(x, out, s, p.vec, st);
  return static_cast<int>(cudaGetLastError());
}

const char* tgp_segment_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
