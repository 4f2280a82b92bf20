// Fused gather + weighted CSR segment-sum for Hopper (sm_90a).
//
//   out[r, :] = sum_{e = row_ptr[r]}^{row_ptr[r+1]-1} (w ? w[e] : 1) * x[idx ? idx[e] : e, :]
//
// over the edges whose row of x has a keep flag of 1 when `keep` is given
// (a row flagged 0 is skipped, not multiplied by 0, so a NaN in it never
// reaches a sum).
//
// Replaces three Pallas TPU kernels of tgp_tpu/ops/pallas/segment_spmm.py:
//   * _grouped_kernel_w (K1), run by spmm_csr -> _gather_kernel_pass: the
//     weighted SpMM over a receiver-sorted static CSR (idx = senders), and
//     its backward over the sender-sorted transpose layout;
//   * _grouped_kernel (K2), run by segment_sum_sorted, and _kernel /
//     sorted_segment_sum_pallas (K4), run by spmm_sorted: the unweighted
//     segment-sum of receiver-sorted messages (idx = null, w = null), K4
//     where its segments are short (long ones take segment_reduce.cu), and
//     the sparse readout's sum of short graphs (idx = the rows' sort order,
//     keep = the mask).
// Every mode rounds each weight to x's type before its product, as the
// TPU kernels' one-hot * w in the messages' dtype does, and clamps a
// gather index to [0, n_x), as JAX's gather and the backward's clip of
// the receivers do.
//
// What bounds it on an H100: bytes.  It does 2 flops per gathered element,
// far below the card's ~295 flop/byte balance point.  The least traffic is
// idx + w + row_ptr + one read of x + one write of out; the gathered rows
// themselves (E*F elements, each row of x about E/N times) come from L2
// while x fits in its 50 MB, so the rate to aim at is L2's gather rate.
//
// What the design does about it.  No warp sums more than S edges of one
// row in the wide mode, nor more than 256 edges in the narrow one, so a
// long row (the collator's padding makes row 0 tens of thousands of edges
// long) is shared by many warps.  Two modes:
//   * wide rows (F > 4): a warp per row sums a row
//     of at most S edges, lanes across columns in 16-byte vectors and lane
//     groups across edges, gathering x[idx_e] straight into f32 registers;
//     a longer row's first S edges go to its own warp and the rest to the
//     tail warps of the S-edge chunks they lie in, which come first in the
//     grid so the long rows never trail it;
//   * narrow rows (F <= 4, one vector or less a row): warp k owns the 256
//     edges [row_ptr[0] + 256k, + 256), each lane 8 consecutive ones; a
//     lane loads its indices, weights and rows of x together, sums its own
//     rows in order, and a segmented scan of the lanes' open sums (keyed by
//     row, by shuffles) finishes rows that cross lanes.  Many rows a warp;
//     rows with no edges are zeroed by row index, a few per warp.
// The warps of a long row keep the last row of x they loaded and load
// again only for another one, so the padding row (sender 0 many times)
// reads x[0] once a lane instead of once an edge.
// A row that one warp cannot finish is summed piece by piece: each piece
// goes with a plain store to its own f32 slot, the warp counts itself on
// the row's integer counter, and the last of the row's warps to arrive
// adds the pieces in chunk order and writes the row.  A warp finds the row
// of a chunk by a 32-way search of row_ptr (about 4 dependent loads).
//
// Why the sum order is fixed: every f32 addition happens in an order set
// by the layout alone (a warp's lanes and edges, the scan's tree, the
// pieces in chunk order); only which warp does the last addition varies,
// and it adds the same numbers in the same order.  No float atomics.
// The counters reset themselves: the last arriver sets its counter back
// to 0, so the caller keeps one zeroed counter buffer per stream and no
// memset runs per call.
//
// Plain C interface (bound with ctypes); the caller allocates `out`, the
// piece slots and the counters, passes PyTorch's current stream, and
// reads the returned cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNarrowMaxF = 4;           // widest row of the narrow mode
constexpr int kNarrowEdgesPerLane = 8;
constexpr int kNarrowRange = kWarp * kNarrowEdgesPerLane;

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

__device__ __forceinline__ int lane_id() { return threadIdx.x & (kWarp - 1); }

// What every mode reads.  R: edges a chunk (S in the wide mode); part: f32
// piece slots, [2, n_ranges, F]: at [0, k] the first piece of the split row
// that starts in chunk k, at [1, k] chunk k's piece of a row that started
// in an earlier chunk; counters: int32 [n_ranges], zero before and after a
// launch.
struct Csr {
  const int32_t* idx;
  const float* w;
  const uint8_t* keep;
  const int32_t* row_ptr;
  int n_x;
  float* part;
  int32_t* counters;
  int num_rows, F, R, n_ranges;
};

// The row of x that edge e gathers (clamped to x's rows) and its weight,
// rounded to T; with KEEP (c.keep given), src = -1 and weight 0 for a row
// whose keep flag is 0.  KEEP is a template flag so that the SpMM modes,
// which never skip, carry no test per edge.
template <typename T, bool KEEP>
__device__ __forceinline__ void edge_src(const Csr& c, int e, int& src,
                                         float& wt) {
  const int s = c.idx != nullptr ? c.idx[e] : e;
  src = min(max(s, 0), c.n_x - 1);
  wt = c.w != nullptr ? to_float(from_float<T>(c.w[e])) : 1.f;
  if (KEEP && c.keep[src] == 0) {
    src = -1;
    wt = 0.f;
  }
}

// Smallest r in [lo, hi] with rp[r] > v, given rp[hi] > v: a 32-way
// search by the whole warp (each round one load a lane and a ballot; ~4
// rounds for 65,536 rows).
__device__ __forceinline__ int first_above(const int32_t* __restrict__ rp,
                                           int lo, int hi, int v) {
  const int lane = lane_id();
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

// Count this warp's piece of a split row on the row's counter (after its
// slot stores); true, on every lane, for the last of `expected` arrivals,
// which then resets the counter and may read every piece.
__device__ __forceinline__ bool arrive(int32_t* counter, int expected) {
  __threadfence();
  __syncwarp();
  int prev = 0;
  if (lane_id() == 0) prev = atomicAdd(counter, 1);
  prev = __shfl_sync(kFull, prev, 0);
  if (prev != expected - 1) return false;
  if (lane_id() == 0) *counter = 0;
  __threadfence();
  return true;
}

// Columns [4q, 4q + CW) of piece j of the split row starting in chunk kf:
// slot [0, kf] for j = 0, else slot [1, kf + j] (read through L2: other
// SMs wrote them).
template <int CW>
__device__ __forceinline__ Pack<float, CW> piece(const Csr& c, int kf, int j,
                                                 int q) {
  const size_t slot = j == 0 ? kf : static_cast<size_t>(c.n_ranges) + kf + j;
  const float* at = c.part + slot * c.F + static_cast<size_t>(q) * CW;
  Pack<float, CW> v;
  if constexpr (CW == 4) {
    const float4 f = __ldcg(reinterpret_cast<const float4*>(at));
    v.v[0] = f.x;
    v.v[1] = f.y;
    v.v[2] = f.z;
    v.v[3] = f.w;
  } else {
#pragma unroll
    for (int k = 0; k < CW; ++k) v.v[k] = __ldcg(at + k);
  }
  return v;
}

// The split row that starts in chunk kf and ends in chunk kl: the sum of
// its pieces (slot [0, kf], then slots [1, kf + 1 .. kl]) written to
// out_row.  Lanes split into column lanes (CW columns each) and piece
// groups; each group adds its pieces in chunk order, 8 loads in flight,
// and the groups meet by a fixed shuffle tree.
template <typename T, int CW>
__device__ void finish_cols(const Csr& c, int kf, int kl, T* __restrict__ out_row) {
  const int lane = lane_id();
  const int quads = c.F / CW;
  int gc = 1;
  while (gc < quads && gc < kWarp) gc <<= 1;
  const int groups = kWarp / gc;
  const int grp = lane / gc, sub = lane - grp * gc;
  const int n = kl - kf + 1;
  for (int q0 = 0; q0 < quads; q0 += gc) {
    const int q = q0 + sub;
    float a[CW];
#pragma unroll
    for (int k = 0; k < CW; ++k) a[k] = 0.f;
    if (q < quads) {
      int j = grp;
      for (; j + 7 * groups < n; j += 8 * groups) {
        Pack<float, CW> v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = piece<CW>(c, kf, j + u * groups, q);
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int k = 0; k < CW; ++k) a[k] += v[u].v[k];
      }
      for (; j < n; j += groups) {
        const Pack<float, CW> v = piece<CW>(c, kf, j, q);
#pragma unroll
        for (int k = 0; k < CW; ++k) a[k] += v.v[k];
      }
    }
    for (int off = gc; off < kWarp; off <<= 1)
#pragma unroll
      for (int k = 0; k < CW; ++k) a[k] += __shfl_xor_sync(kFull, a[k], off);
    if (grp == 0 && q < quads)
#pragma unroll
      for (int k = 0; k < CW; ++k) out_row[q * CW + k] = from_float<T>(a[k]);
  }
}

template <typename T>
__device__ void finish_row(const Csr& c, int kf, int kl, T* __restrict__ out_row) {
  if (c.F % 4 == 0)
    finish_cols<T, 4>(c, kf, kl, out_row);
  else
    finish_cols<T, 1>(c, kf, kl, out_row);
}

// Rows [k*per, (k+1)*per) that have no edges, zeroed (every row of out is
// written once: rows with edges by their chunks' warps).  Narrow mode.
template <typename T>
__device__ void zero_empty_rows(T* __restrict__ out, const Csr& c, int k) {
  const int lane = lane_id();
  const int per = (c.num_rows + c.n_ranges - 1) / c.n_ranges;
  const long long first = static_cast<long long>(k) * per;
  if (first >= c.num_rows) return;
  const int r0 = static_cast<int>(first);
  const int r1 = min(r0 + per, c.num_rows);
  for (int base = r0; base < r1; base += kWarp) {
    const int r = base + lane;
    const bool empty = r < r1 && c.row_ptr[r] == c.row_ptr[r + 1];
    unsigned m = __ballot_sync(kFull, empty);
    if (c.F < kWarp) {
      if (empty)
        for (int j = 0; j < c.F; ++j)
          out[static_cast<size_t>(r) * c.F + j] = from_float<T>(0.f);
    } else {
      while (m != 0) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        T* row = out + static_cast<size_t>(base + j) * c.F;
        for (int col = lane; col < c.F; col += kWarp) row[col] = from_float<T>(0.f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// wide rows
// ---------------------------------------------------------------------------

// Sum of w_e * x[src_e] over edges [start, end) of one row, in f32: written
// to `out_row` in T, or to the f32 piece slot `slot` with plain stores.
// REUSE (the pieces of long rows): a lane keeps the last row of x it
// loaded and loads again only for another row, so a long row that gathers
// one row many times (the collator's padding: sender 0, weight 0) reads it
// once a lane; the products and their order are the same.  Rows of at
// most S edges skip the comparison.
// The warp splits into kWarp / G lane groups of G lanes; group g takes
// edges g, g + groups, ... of each 32-edge batch, lane `sub` of a group owns
// columns [c * VEC, (c + 1) * VEC) of the current G * VEC-wide column tile,
// and the groups meet by shuffles.  All loop bounds are uniform across the
// warp, so every shuffle runs with the full mask.
template <typename T, int VEC, bool REUSE, bool KEEP>
__device__ __forceinline__ void slice_sum(const T* __restrict__ x,
                                          const Csr& c, int start, int end,
                                          int G, T* __restrict__ out_row,
                                          float* __restrict__ slot) {
  const int lane = lane_id();
  const int groups = kWarp / G;
  const int grp = lane / G;
  const int sub = lane - grp * G;
  const int F = c.F;
  const int chunks = F / VEC;
  for (int c0 = 0; c0 < chunks; c0 += G) {
    const int col = c0 + sub;
    const bool col_ok = col < chunks;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

    int last = -1;  // the row of x held in `p`
    Pack<T, VEC> p;
    for (int base = start; base < end; base += kWarp) {
      const int e = base + lane;
      int my_src = -1;
      float my_w = 0.f;
      if (e < end) edge_src<T, KEEP>(c, e, my_src, my_w);
      const int n = min(kWarp, end - base);
#pragma unroll 4
      for (int j0 = 0; j0 < n; j0 += groups) {
        const int j = j0 + grp;
        const int src = __shfl_sync(kFull, my_src, j & (kWarp - 1));
        const float we = __shfl_sync(kFull, my_w, j & (kWarp - 1));
        if (j < n && col_ok && src >= 0) {
          if (!REUSE || src != last) {
            p = *reinterpret_cast<const Pack<T, VEC>*>(
                x + static_cast<size_t>(src) * F + static_cast<size_t>(col) * VEC);
            last = src;
          }
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
      if (slot == nullptr) {
        Pack<T, VEC> p;
#pragma unroll
        for (int k = 0; k < VEC; ++k) p.v[k] = from_float<T>(acc[k]);
        *reinterpret_cast<Pack<T, VEC>*>(out_row + static_cast<size_t>(col) * VEC) = p;
      } else {
        Pack<float, VEC> p;
#pragma unroll
        for (int k = 0; k < VEC; ++k) p.v[k] = acc[k];
        *reinterpret_cast<Pack<float, VEC>*>(slot + static_cast<size_t>(col) * VEC) = p;
      }
    }
  }
}

// Warps [0, n_ranges) are the tail warps of the S-edge chunks [base + k*S,
// + S), and warp n_ranges + r is row r's: the long-row work comes first in
// the grid.  Row r's warp sums the whole row when it has at most S edges
// (an empty row gets zeros), else its first S edges; tail warp k sums the
// edges of its chunk that lie more than S past the start of their row.  A
// chunk holds the tail of at most one row (a row starting inside it keeps
// its first S edges for its own warp), and at most one row longer than S
// starts in each chunk, so a long row starting in chunk kf owns slot
// [0, kf] for its head and its tails sit in slots [1, kf + 1 .. kl]: the
// warps store their pieces there and the last to arrive adds them in
// chunk order.
template <typename T, int VEC, bool KEEP>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    csr_wide_kernel(const T* __restrict__ x, T* __restrict__ out, Csr c,
                    int G) {
  const int w = blockIdx.x * kWarpsPerBlock + static_cast<int>(threadIdx.x) / kWarp;
  const int32_t* rp = c.row_ptr;
  const int base = rp[0], S = c.R;
  int row, rs, re, start, end;
  float* slot;
  if (w < c.n_ranges) {
    const int p = base + w * S;
    if (p >= rp[c.num_rows]) return;
    row = first_above(rp, 0, c.num_rows, p) - 1;
    rs = rp[row];
    re = rp[row + 1];
    start = max(p, rs + S);
    end = min(p + S, re);
    if (start >= end) return;  // no tail edges in this chunk
    slot = c.part + static_cast<size_t>(c.n_ranges + w) * c.F;
  } else {
    row = w - c.n_ranges;
    if (row >= c.num_rows) return;
    rs = rp[row];
    re = rp[row + 1];
    if (re - rs <= S) {
      slice_sum<T, VEC, false, KEEP>(x, c, rs, re, G,
                               out + static_cast<size_t>(row) * c.F, nullptr);
      return;
    }
    start = rs;
    end = rs + S;
    slot = c.part + static_cast<size_t>((rs - base) / S) * c.F;
  }
  slice_sum<T, VEC, true, KEEP>(x, c, start, end, G, nullptr, slot);
  const int kf = (rs - base) / S, kl = (re - 1 - base) / S;
  if (arrive(c.counters + kf, kl - kf + 1))
    finish_row<T>(c, kf, kl, out + static_cast<size_t>(row) * c.F);
}

// ---------------------------------------------------------------------------
// narrow rows
// ---------------------------------------------------------------------------

// Per lane: last r in [lo, hi] with rp[r] <= v (rp[lo] <= v given).
__device__ __forceinline__ int last_at_or_below(const int32_t* __restrict__ rp,
                                                int lo, int hi, int v) {
  while (lo < hi) {
    const int m = (lo + hi + 1) >> 1;
    if (rp[m] <= v) lo = m; else hi = m - 1;
  }
  return lo;
}

// Warp k: zero its share of the empty rows, then sum edges [p0, p1) = [base
// + k*kNarrowRange, + kNarrowRange), lane l owning kNarrowEdgesPerLane
// consecutive ones.  A lane writes the rows that start and end among its
// edges; the sums still open at each lane's end are scanned across lanes
// by row, which finishes rows that cross lanes inside the range; the
// pieces of the rows that cross p0 or p1 go to their slots, as in the
// wide mode.
template <typename T, int NF, bool KEEP>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    csr_narrow_kernel(const T* __restrict__ x, T* __restrict__ out, Csr c) {
  constexpr int L = kNarrowEdgesPerLane;
  const int lane = lane_id();
  const int k = blockIdx.x * kWarpsPerBlock + static_cast<int>(threadIdx.x) / kWarp;
  if (k >= c.n_ranges) return;
  zero_empty_rows<T>(out, c, k);
  const int32_t* rp = c.row_ptr;
  const int base = rp[0], e_end = rp[c.num_rows];
  const int p0 = base + k * kNarrowRange;
  if (p0 >= e_end) return;
  const int p1 = min(p0 + kNarrowRange, e_end);
  const int r_first = first_above(rp, 0, c.num_rows, p0) - 1;
  const int r_hi = c.num_rows - 1;
  const int rp_first = rp[r_first];
  const bool in_row = rp_first < p0;  // row r_first started in an earlier range

  const int lo = min(p0 + lane * L, p1), hi = min(lo + L, p1);
  const bool has = lo < hi;
  // my first row (the last to start at or before lo), counted among the
  // 32 row starts from r_first (one load a lane); searched past them
  const int wv = r_first + lane <= c.num_rows ? rp[r_first + lane] : INT_MAX;
  int starts = 0;
  for (int j = 0; j < kWarp; ++j) starts += __shfl_sync(kFull, wv, j) <= lo;
  int r = starts < kWarp ? r_first + starts - 1
                         : last_at_or_below(rp, r_first + kWarp - 1, r_hi, lo);
  if (!has) r = r_first;
  int r_end = has ? rp[r + 1] : 0;
  bool own = has && rp[r] >= lo;  // the current row starts among my edges

  int src[L];
  float wt[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    src[j] = 0;
    wt[j] = 0.f;
    if (lo + j < hi) edge_src<T, KEEP>(c, lo + j, src[j], wt[j]);
  }
  float v[L][NF];
#pragma unroll
  for (int j = 0; j < L; ++j)
#pragma unroll
    for (int f = 0; f < NF; ++f)
      v[j][f] = lo + j < hi && src[j] >= 0
                    ? to_float(x[static_cast<size_t>(src[j]) * NF + f]) : 0.f;

  float acc[NF], head[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = head[f] = 0.f;
  int head_row = -1;  // a row that started before my edges and ends among them
  bool open = has;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int e = lo + j;
    if (e < hi) {
#pragma unroll
      for (int f = 0; f < NF; ++f) acc[f] = fmaf(wt[j], v[j][f], acc[f]);
      if (e + 1 == r_end) {
        if (own) {
#pragma unroll
          for (int f = 0; f < NF; ++f)
            out[static_cast<size_t>(r) * NF + f] = from_float<T>(acc[f]);
        } else {
          head_row = r;
#pragma unroll
          for (int f = 0; f < NF; ++f) head[f] = acc[f];
        }
#pragma unroll
        for (int f = 0; f < NF; ++f) acc[f] = 0.f;
        open = false;
        if (e + 1 < hi) {  // the next row with edges starts at e + 1
          r = rp[r + 2] > e + 1 ? r + 1 : last_at_or_below(rp, r + 2, r_hi, e + 1);
          r_end = rp[r + 1];
          own = true;
          open = true;
        }
      }
    }
  }

  // segmented inclusive scan of the open sums, keyed by row
  int key = open ? r : -1;
  float s[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) s[f] = acc[f];
  for (int off = 1; off < kWarp; off <<= 1) {
    const int k2 = __shfl_up_sync(kFull, key, off);
    float t[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) t[f] = __shfl_up_sync(kFull, s[f], off);
    if (lane >= off && key >= 0 && k2 == key) {
#pragma unroll
      for (int f = 0; f < NF; ++f) s[f] = t[f] + s[f];
    }
  }
  int in_key = __shfl_up_sync(kFull, key, 1);
  float in_s[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) in_s[f] = __shfl_up_sync(kFull, s[f], 1);
  if (lane == 0) in_key = -1;

  // a row that started among earlier lanes of this range and ends here
  if (head_row >= 0 && !(in_row && head_row == r_first)) {
#pragma unroll
    for (int f = 0; f < NF; ++f)
      out[static_cast<size_t>(head_row) * NF + f] = from_float<T>(
          (in_key == head_row ? in_s[f] : 0.f) + head[f]);
  }

  const int last = (p1 - 1 - p0) / L;  // last lane with edges
  if (in_row) {  // this range's piece of row r_first
    const unsigned m = __ballot_sync(kFull, head_row == r_first);
    const int from = m != 0 ? __ffs(m) - 1 : last;
    if (lane == from) {
      float* slot = c.part + static_cast<size_t>(c.n_ranges + k) * NF;
#pragma unroll
      for (int f = 0; f < NF; ++f)
        slot[f] = m != 0 ? (in_key == r_first ? in_s[f] : 0.f) + head[f] : s[f];
    }
    const int kf = (rp_first - base) / kNarrowRange;
    const int kl = (rp[r_first + 1] - 1 - base) / kNarrowRange;
    if (arrive(c.counters + kf, kl - kf + 1))
      finish_row<T>(c, kf, kl, out + static_cast<size_t>(r_first) * NF);
  }
  const int co = __shfl_sync(kFull, key, last);  // open at p1
  if (co >= 0 && !(in_row && co == r_first)) {  // the piece of a row owned here
    if (lane == last) {
      float* slot = c.part + static_cast<size_t>(k) * NF;
#pragma unroll
      for (int f = 0; f < NF; ++f) slot[f] = s[f];
    }
    const int kl = (rp[co + 1] - 1 - base) / kNarrowRange;
    if (arrive(c.counters + k, kl - k + 1))
      finish_row<T>(c, k, kl, out + static_cast<size_t>(co) * NF);
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

bool narrow_mode(int F) { return F <= kNarrowMaxF; }

int edges_per_range(int F, int S) { return narrow_mode(F) ? kNarrowRange : S; }

int ranges_for(int n_edges, int F, int S) {
  return n_edges / edges_per_range(F, S) + 1;
}

int blocks_for(int n_ranges) {
  return (n_ranges + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

template <typename T, int VEC, bool KEEP>
void launch_wide(const void* x, void* out, const Csr& c, cudaStream_t stream) {
  const int chunks = c.F / VEC;
  int G = 1;
  while (G < chunks && G < kWarp) G *= 2;
  const long long warps = static_cast<long long>(c.n_ranges) + c.num_rows;
  const int blocks = static_cast<int>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  csr_wide_kernel<T, VEC, KEEP><<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), c, G);
}

template <typename T, bool KEEP>
void dispatch(const void* x, void* out, const Csr& c, cudaStream_t stream) {
  const dim3 grid(blocks_for(c.n_ranges)), block(kWarp * kWarpsPerBlock);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (narrow_mode(c.F)) {
    switch (c.F) {
      case 1: csr_narrow_kernel<T, 1, KEEP><<<grid, block, 0, stream>>>(xt, ot, c); break;
      case 2: csr_narrow_kernel<T, 2, KEEP><<<grid, block, 0, stream>>>(xt, ot, c); break;
      case 3: csr_narrow_kernel<T, 3, KEEP><<<grid, block, 0, stream>>>(xt, ot, c); break;
      default: csr_narrow_kernel<T, 4, KEEP><<<grid, block, 0, stream>>>(xt, ot, c); break;
    }
    return;
  }
  switch (pick_vec<T>(x, out, c.F)) {
    case 8: launch_wide<T, 8, KEEP>(x, out, c, stream); break;
    case 4: launch_wide<T, 4, KEEP>(x, out, c, stream); break;
    case 2: launch_wide<T, 2, KEEP>(x, out, c, stream); break;
    default: launch_wide<T, 1, KEEP>(x, out, c, stream);
  }
}

}  // namespace

extern "C" {

// Edge chunks of one call: part must hold 2 * chunks * F floats and
// counters `chunks` int32 zeros.  S: the wide mode's most edges a warp.
int tgp_csr_ranges(int n_edges, int F, int S) {
  return ranges_for(n_edges, F, S);
}

// dtype: 0 = float32, 1 = bfloat16 (x and out).  idx, w and keep (uint8
// [n_x]) may be null.  n_x: x's rows; n_edges: idx's length (x's rows without idx), at least
// row_ptr[num_rows].  part: f32 [2, n_ranges, F] scratch; counters: int32
// [n_ranges], zero on entry and left zero; n_ranges = tgp_csr_ranges(
// n_edges, F, S).  Returns the first CUDA error (0 = cudaSuccess).
int tgp_csr_spmm(const void* x, const void* idx, const void* w,
                 const void* keep, const void* row_ptr, int n_x, int n_edges,
                 void* part, void* counters, void* out, int num_rows, int F,
                 int S, int n_ranges, int dtype, void* stream) {
  if (num_rows <= 0 || F <= 0 || S <= 0 || n_x <= 0 || n_edges < 0 ||
      n_ranges != ranges_for(n_edges, F, S))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Csr c{static_cast<const int32_t*>(idx), static_cast<const float*>(w),
              static_cast<const uint8_t*>(keep),
              static_cast<const int32_t*>(row_ptr), n_x,
              static_cast<float*>(part), static_cast<int32_t*>(counters),
              num_rows, F, edges_per_range(F, S), n_ranges};
  if (dtype == 0) {
    if (keep)
      dispatch<float, true>(x, out, c, s);
    else
      dispatch<float, false>(x, out, c, s);
  } else if (dtype == 1) {
    if (keep)
      dispatch<__nv_bfloat16, true>(x, out, c, s);
    else
      dispatch<__nv_bfloat16, false>(x, out, c, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tgp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
