// Banded (windowed) SpMM for Hopper (sm_90a): K5,
//
//   out[r, :] = sum_{e = row_ptr[r]}^{row_ptr[r+1]-1} w_e * x[s_e, :]   over the
//               senders s_e in [base_b, min(base_b + window, n_x)),  b = r / block_rows,
//
// the weights rounded to x's type before the product, f32 sums, out in x's
// type (f32 or bf16).  Receiver block b owns the edges [row_ptr[b *
// block_rows], row_ptr[(b + 1) * block_rows]) (block 0 from edge 0); base_b
// is the smallest of their senders (n_pad = max(n_x, window) when there is
// none) rounded down to 8 and clipped to [0, n_pad - window].  Senders
// outside the window add nothing.
//
// Replaces the Pallas TPU kernel _banded_kernel / banded_sorted_spmm_pallas
// of tgp_tpu/ops/pallas/segment_spmm.py (K5), run by spmm_banded.  The TPU
// kernel copied each receiver block's window of x into VMEM and turned the
// gather into a one-hot matmul; the window is the kernel's contract, so it
// holds here too.
//
// What bounds it on an H100: bytes.  Two flops per gathered element; the
// least traffic is the senders, weights and row_ptr, one read of x and one
// write of out.  Gathering every edge's row from L2 moves 2 E F elements
// (16 reads of each row on a banded graph of 16 edges a row): consecutive
// receiver blocks' windows overlap almost entirely.
//
// What the design does about it: a block of 1,024 threads owns a run of
// consecutive receiver blocks and one 128-byte slice of F (64 bf16 or 32
// f32 values), and keeps x's rows of that slice in a shared-memory ring of
// 1,472 rows that slides with the windows: a step is one receiver block,
// its target the block's window (capped at the ring's size), and only the
// rows new to the ring are copied in (cp.async, 16 bytes a thread, or
// element by element where rows are not 16-byte aligned).  When the next
// step's new rows land in slots the current step does not read, they are
// copied while it computes.  A falling or jumping window reloads the
// target; a sender inside its window but outside the target (a window
// wider than the ring) is read from device memory by the same code.  The
// run is sized so that the grid (runs x slices) about covers the card.
// The window starts are found by the same kernel, with the whole block
// over each receiver block's senders: the first step's first, so that its
// window is copied while the run's others are found (no pre-pass launch,
// no scratch).  Each step's senders, weights and row offsets are loaded
// into registers while the step before computes, and staged in shared
// memory as (ring offset or far row, weight rounded to x's type) pairs.
// An 8-lane group sums one receiver row, its edges in order, each lane 16
// bytes of the slice, so a quarter-warp reads one whole 128-byte ring row
// (no bank conflicts); a step whose senders all lie in the ring takes a
// loop without branches, its shared-memory loads unrolled 4 deep.  Every
// sum is in an order set by the layout, so two runs give the same bits.
//
// Plain C interface (bound with ctypes); the caller allocates `out`, passes
// PyTorch's current stream, and reads the returned cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 1024;
constexpr int kUnrollEdges = 4;  // edges of a row a lane group unrolls
constexpr int kWarps = kThreads / kWarp;
constexpr int kSliceBytes = 128;  // the part of a row staged at a time
constexpr int kLanesPerRow = kSliceBytes / 16;
constexpr int kEdgeGroups = kWarp / kLanesPerRow;
constexpr int kRing = 1472;               // rows of x's ring
constexpr int kStage = 4096;              // a step's edges staged in shared memory
constexpr int kStagePerThread = kStage / kThreads;
constexpr int kMaxBlockRows = 1024;       // rows of a receiver block
constexpr int kRpPerThread = (kMaxBlockRows + kThreads) / kThreads;
constexpr int kMaxRun = 32;               // receiver blocks a thread block
constexpr int kScanBlocks = 8;            // receiver blocks scanned at once
constexpr int kScanLoads = 2048 / kThreads;  // loads a thread a block a round
constexpr int kSmemBytes = kRing * kSliceBytes + kStage * 8 +  // ring, (code, w)
                           (kMaxBlockRows + 1) * 4 + (3 * kMaxRun + 3) * 4;
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

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

struct Band {
  const int32_t* idx;
  const float* w;
  const int32_t* row_ptr;
  int n_x, n_edges, num_rows, F, window, block_rows, n_blocks, per_run,
      n_slices;
};

// Rounded down to a multiple of 8, then clipped to [0, max(n_pad - window, 0)].
__device__ __forceinline__ int window_start(int m, int n_pad, int window) {
  const int floor8 = (m >= 0 ? m / 8 : -((-m + 7) / 8)) * 8;
  return min(max(floor8, 0), max(n_pad - window, 0));
}

// Rows [lo, hi) of x held in the ring, row x in slot x % kRing.
struct Ring {
  int lo, hi;
};

// What to copy so that a ring holding `cur` holds the target [t_lo, t_hi)
// (t_hi - t_lo <= kRing): when the target starts inside what is held, the
// rows past its end; else the whole target.  Returns the rows to copy in
// [*load_lo, *load_hi) and updates `cur`.
__device__ __forceinline__ void plan(Ring& cur, int t_lo, int t_hi,
                                     int* load_lo, int* load_hi) {
  if (t_lo >= t_hi) {  // nothing read from the ring
    *load_lo = *load_hi = 0;
  } else if (t_lo >= cur.lo && t_lo <= cur.hi) {
    *load_lo = cur.hi;
    *load_hi = max(cur.hi, t_hi);
    cur.hi = *load_hi;
    cur.lo = max(cur.lo, cur.hi - kRing);
  } else {
    *load_lo = cur.lo = t_lo;
    *load_hi = cur.hi = t_hi;
  }
}

// Copying rows [lo, hi) into the ring cannot touch a slot that the current
// step reads (its target [c_lo, c_hi)).
__device__ __forceinline__ bool disjoint(int lo, int hi, int c_lo, int c_hi) {
  return lo >= hi || c_lo >= c_hi || (lo >= c_hi && hi <= c_lo + kRing);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Columns [f0, f0 + wd) of rows [lo, hi) of x [*, F] into the ring; VEC > 1:
// 16-byte asynchronous copies (rows 16-byte aligned), else element copies.
template <typename T, int VEC>
__device__ __forceinline__ void load_rows(unsigned char* ring,
                                          const T* __restrict__ x, int lo,
                                          int hi, int F, int f0, int wd) {
  const int per_row = wd / VEC;
  const int n = (hi - lo) * per_row;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int row = lo + i / per_row, q = i % per_row;
    const T* src = x + static_cast<size_t>(row) * F + f0 + q * VEC;
    T* dst = reinterpret_cast<T*>(ring + (row % kRing) * kSliceBytes) + q * VEC;
    if constexpr (VEC > 1)
      cp_async16(dst, src);
    else
      *dst = *src;
  }
}

// The edge ranges of receiver blocks c0 .. c0 + P - 1 whose smallest
// sender sets their window starts: bnd[i] is block c0 + i's first edge (0
// for block 0), bnd[P] the last's end; mn[i] starts at n_pad.
__device__ void window_bounds(const Band& b, int c0, int P, int* bnd,
                              int* mn) {
  const int tid = threadIdx.x;
  if (tid <= P) {
    const int c = c0 + tid;
    bnd[tid] = c == 0 ? 0 : min(b.row_ptr[c * b.block_rows], b.n_edges);
  }
  if (tid < P) mn[tid] = max(b.n_x, b.window);
  __syncthreads();
}

// The window starts of blocks first .. last - 1 of the run into base[]:
// the whole block takes kScanBlocks receiver blocks at a time, in rounds
// of 2,048 senders each with all their loads in flight (a round per 2,048
// senders of the longest), then a warp minimum and a shared-memory
// atomicMin a warp.
__device__ void window_starts(const Band& b, int first, int last,
                              const int* bnd, int* mn, int* base) {
  const int tid = threadIdx.x;
  const int n_pad = max(b.n_x, b.window);
  for (int i0 = first; i0 < last; i0 += kScanBlocks) {
    int longest = 0;
    for (int a = 0; a < kScanBlocks && i0 + a < last; ++a)
      longest = max(longest, bnd[i0 + a + 1] - bnd[i0 + a]);
    int m[kScanBlocks];
#pragma unroll
    for (int a = 0; a < kScanBlocks; ++a) m[a] = INT_MAX;
    for (int r0 = 0; r0 < longest; r0 += kScanLoads * kThreads) {
      int v[kScanBlocks][kScanLoads];
#pragma unroll
      for (int a = 0; a < kScanBlocks; ++a) {
        const int i = i0 + a;
        const int lo = i < last ? bnd[i] : 0, hi = i < last ? bnd[i + 1] : 0;
#pragma unroll
        for (int u = 0; u < kScanLoads; ++u) {
          const int e = lo + r0 + tid + u * kThreads;
          v[a][u] = e < hi ? b.idx[e] : INT_MAX;
        }
      }
#pragma unroll
      for (int a = 0; a < kScanBlocks; ++a)
#pragma unroll
        for (int u = 0; u < kScanLoads; ++u) m[a] = min(m[a], v[a][u]);
    }
#pragma unroll
    for (int a = 0; a < kScanBlocks; ++a) {
      const int ma = __reduce_min_sync(kFull, m[a]);
      if ((tid & (kWarp - 1)) == 0 && i0 + a < last && ma < n_pad)
        atomicMin(&mn[i0 + a], ma);
    }
  }
  __syncthreads();
  if (tid >= first && tid < last) base[tid] = window_start(mn[tid], n_pad, b.window);
  __syncthreads();
}

// acc[k] += wt * value k of a 16-byte piece p (4 f32 or 8 bf16 values).
template <typename T, int kPer>
__device__ __forceinline__ void fma_piece(float (&acc)[kPer], float wt,
                                          const uint4& p) {
  const uint32_t u[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    // a bf16 is the high half of the f32 of the same value
    const uint32_t bits = sizeof(T) == 4 ? u[k]
                          : (k % 2 == 0 ? u[k / 2] << 16 : u[k / 2] & 0xffff0000u);
    acc[k] = fmaf(wt, __uint_as_float(bits), acc[k]);
  }
}

// acc += wt * columns [sub * kPer, + kPer) (those below wd) of the slice of
// an edge's sender, whose code says where it lies: code >= 0, at that byte
// offset in the ring; else row -2 - code of x in device memory.  Shared and
// device loads are kept apart, so the ring's are plain shared-memory loads.
template <typename T, int VEC, int kPer>
__device__ __forceinline__ void accumulate(float (&acc)[kPer], float wt,
                                           int code, const unsigned char* ring,
                                           const T* __restrict__ x, int F,
                                           int f0, int sub, int wd) {
  if constexpr (VEC > 1) {
    if (sub * kPer >= wd) return;
    uint4 p;
    if (code >= 0)
      p = reinterpret_cast<const uint4*>(ring + code)[sub];
    else
      p = reinterpret_cast<const uint4*>(x + static_cast<size_t>(-2 - code) * F + f0)[sub];
    fma_piece<T, kPer>(acc, wt, p);
  } else {
    const T* row = code >= 0 ? reinterpret_cast<const T*>(ring + code)
                             : x + static_cast<size_t>(-2 - code) * F + f0;
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (sub * kPer + k < wd) acc[k] = fmaf(wt, to_float(row[sub * kPer + k]), acc[k]);
  }
}

// Columns [sub * kPer, + kPer) of a row's slice (those below wd) to dst.
template <typename T, int VEC, int kPer>
__device__ __forceinline__ void store_row(T* __restrict__ dst,
                                          const float (&acc)[kPer], int sub,
                                          int wd) {
  if constexpr (VEC > 1) {
    if (sub * kPer >= wd) return;
    Pack<T, VEC> p;
#pragma unroll
    for (int k = 0; k < kPer; ++k) p.v[k] = from_float<T>(acc[k]);
    reinterpret_cast<Pack<T, VEC>*>(dst)[sub] = p;
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (sub * kPer + k < wd) dst[sub * kPer + k] = from_float<T>(acc[k]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
    banded_ring_kernel(const T* __restrict__ x, T* __restrict__ out, Band b) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  int2* st_cw = reinterpret_cast<int2*>(ring + kRing * kSliceBytes);
  int32_t* st_rp = reinterpret_cast<int32_t*>(st_cw + kStage);
  int* bnd = st_rp + kMaxBlockRows + 1;  // [kMaxRun + 1]
  int* mn = bnd + kMaxRun + 1;           // [kMaxRun]
  int* base = mn + kMaxRun;              // [kMaxRun]
  int* far = base + kMaxRun;  // [2]: step t's staged senders leave the ring
  constexpr int kSlice = kSliceBytes / static_cast<int>(sizeof(T));
  constexpr int kPer = kSlice / kLanesPerRow;  // elements a lane
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int grp = lane / kLanesPerRow, sub = lane % kLanesPerRow;
  const int run = blockIdx.x / b.n_slices, slice = blockIdx.x % b.n_slices;
  const int c0 = run * b.per_run, P = min(b.per_run, b.n_blocks - c0);
  const int f0 = slice * kSlice, wd = min(kSlice, b.F - f0);
  const int BR = b.block_rows;

  if (tid == 0) far[0] = far[1] = 0;  // published by the barriers below
  window_bounds(b, c0, P, bnd, mn);
  window_starts(b, 0, 1, bnd, mn, base);  // the first step's, then its copy

  // step t: receiver block c0 + t; its target [base, min(base + window,
  // n_x, base + kRing))
  auto target = [&](int t, int* lo, int* hi) {
    *lo = base[t];
    *hi = max(min(min(*lo + b.window, b.n_x), *lo + kRing), *lo);
  };
  Ring held{0, 0};
  int ld_lo = 0, ld_hi = 0;  // the next copy
  auto issue = [&]() {
    load_rows<T, VEC>(ring, x, ld_lo, ld_hi, b.F, f0, wd);
    if constexpr (VEC > 1) asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // a step's senders, weights and row offsets, loaded into registers
  int r_s[kStagePerThread], r_rp[kRpPerThread];
  float r_w[kStagePerThread];
  auto fetch = [&](int t) {
    const int row0 = (c0 + t) * BR;
    const int e0 = b.row_ptr[row0], e1 = b.row_ptr[row0 + BR];
#pragma unroll
    for (int u = 0; u < kStagePerThread; ++u) {
      const int e = e0 + tid + u * kThreads;
      r_s[u] = e < e1 ? b.idx[e] : 0;
      r_w[u] = e < e1 ? b.w[e] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kRpPerThread; ++u) {
      const int m = tid + u * kThreads;
      r_rp[u] = m <= BR ? b.row_ptr[row0 + m] : 0;
    }
  };
  // an edge of step t: its code (see accumulate) and weight, rounded to T
  auto code_of = [&](int t, int sv, float wv) {
    int lo, hi;
    target(t, &lo, &hi);
    const int w_lo = base[t], w_hi = min(w_lo + b.window, b.n_x);
    int code = -1;
    if (sv >= w_lo && sv < w_hi) {
      if (sv >= lo && sv < hi) {
        int slot = sv - lo + lo % kRing;  // sv's slot, sv % kRing
        if (slot >= kRing) slot -= kRing;
        code = slot * kSliceBytes;
      } else {
        code = -2 - sv;
      }
    }
    return make_int2(code, __float_as_int(to_float(from_float<T>(wv))));
  };
  // step t's edges, staged as (code, weight) pairs, and its row offsets;
  // far[t % 2] says whether a staged sender is read from device memory
  auto stage = [&](int t) {
    bool any_far = false;
#pragma unroll
    for (int u = 0; u < kStagePerThread; ++u) {
      const int2 cw = code_of(t, r_s[u], r_w[u]);
      any_far |= cw.x < -1;
      st_cw[tid + u * kThreads] = cw;
    }
    if (any_far) far[t & 1] = 1;
#pragma unroll
    for (int u = 0; u < kRpPerThread; ++u)
      if (tid + u * kThreads <= BR) st_rp[tid + u * kThreads] = r_rp[u];
  };

  {
    int lo, hi;
    target(0, &lo, &hi);
    plan(held, lo, hi, &ld_lo, &ld_hi);
    issue();
    fetch(0);
    // the run's other window starts while the first window is copied
    window_starts(b, 1, P, bnd, mn, base);
    stage(0);
  }
  for (int t = 0; t < P; ++t) {
    if (t + 1 < P) fetch(t + 1);
    if constexpr (VEC > 1) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the ring holds this step's target; its edges are staged
    // far[(t + 1) % 2] was last read by step t - 1; step t + 1's staging
    // (after this step's last barrier) sets it
    if (tid == 0) far[(t + 1) & 1] = 0;

    int t_lo, t_hi;
    target(t, &t_lo, &t_hi);
    bool early = false;
    if (t + 1 < P) {
      int n_lo, n_hi;
      target(t + 1, &n_lo, &n_hi);
      plan(held, n_lo, n_hi, &ld_lo, &ld_hi);
      early = disjoint(ld_lo, ld_hi, t_lo, t_hi);
      if (early) issue();  // overlaps this step's products
    }

    // A lane group sums one receiver row at a time, its edges in order:
    // lane sub owns 16 bytes of the slice.  Rows whose edges are all staged
    // and in the ring (every row of a banded step) take a loop without
    // branches, so its shared-memory loads go out together; the others
    // (far senders, or a step of more than kStage edges) the general one.
    const int row0 = (c0 + t) * BR, e_first = st_rp[0];
    const bool near = far[t & 1] == 0;
    for (int rr = warp * kEdgeGroups + grp; rr < BR; rr += kWarps * kEdgeGroups) {
      const int rs = st_rp[rr], re = st_rp[rr + 1];
      float acc[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
      if (VEC > 1 && near && re - e_first <= kStage) {
        const bool lane_on = sub * kPer < wd;
#pragma unroll kUnrollEdges
        for (int e = rs; e < re; ++e) {
          const int2 cw = st_cw[e - e_first];
          const bool on = lane_on && cw.x >= 0;  // else outside the window
          uint4 p = make_uint4(0, 0, 0, 0);
          if (on) p = reinterpret_cast<const uint4*>(ring + cw.x)[sub];
          fma_piece<T, kPer>(acc, on ? __int_as_float(cw.y) : 0.f, p);
        }
      } else {
        for (int e = rs; e < re; ++e) {
          const int2 cw = e - e_first < kStage ? st_cw[e - e_first]
                                               : code_of(t, b.idx[e], b.w[e]);
          if (cw.x != -1)
            accumulate<T, VEC, kPer>(acc, __int_as_float(cw.y), cw.x, ring, x,
                                     b.F, f0, sub, wd);
        }
      }
      store_row<T, VEC, kPer>(out + static_cast<size_t>(row0 + rr) * b.F + f0, acc, sub, wd);
    }

    __syncthreads();  // every thread is done with the staged edges and the slots
    if (t + 1 < P) {
      if (!early) issue();
      stage(t + 1);
    }
  }
}

// Raises the kernel's dynamic shared-memory limit once per device (one bit
// a device in `raised`).
template <typename Kernel>
int raise_smem_limit(Kernel kernel, std::atomic<uint64_t>& raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit && (raised.load(std::memory_order_relaxed) & bit)) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  raised.fetch_or(bit, std::memory_order_relaxed);
  return 0;
}

template <typename T, int VEC>
int launch(const void* x, void* out, Band b, cudaStream_t stream) {
  static std::atomic<uint64_t> raised{0};
  auto kernel = banded_ring_kernel<T, VEC>;
  int err = raise_smem_limit(kernel, raised);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // about one block an SM (the ring fills the SM's shared memory); the sum
  // order does not depend on the run's length
  constexpr int kSlice = kSliceBytes / static_cast<int>(sizeof(T));
  b.n_slices = (b.F + kSlice - 1) / kSlice;
  b.n_blocks = b.num_rows / b.block_rows;
  const int work = b.n_blocks * b.n_slices;
  b.per_run = min(max((work + sms - 1) / sms, 1), kMaxRun);
  const int runs = (b.n_blocks + b.per_run - 1) / b.per_run;
  kernel<<<runs * b.n_slices, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out).  vector: 1 for 16-byte
// copies and loads (F * itemsize % 16 == 0 and x 16-byte aligned, which the
// caller's route promises and this checks), 0 for element copies.
// n_edges: idx's and w's length, at least row_ptr[num_rows]; num_rows a
// multiple of block_rows (at most 1,024).  Returns the first CUDA error
// (0 = cudaSuccess).
int tgp_banded_spmm(const void* x, const void* idx, const void* w,
                    const void* row_ptr, void* out, int n_x, int n_edges,
                    int num_rows, int F, int window, int block_rows,
                    int dtype, int vector, void* stream) {
  if (n_x <= 0 || n_edges < 0 || num_rows <= 0 || F <= 0 || window <= 0 ||
      block_rows <= 0 || block_rows > kMaxBlockRows ||
      num_rows % block_rows != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t item = dtype == 0 ? 4 : 2;
  const bool aligned = (static_cast<size_t>(F) * item) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vector != 0 && !aligned) return static_cast<int>(cudaErrorInvalidValue);
  const Band b{static_cast<const int32_t*>(idx), static_cast<const float*>(w),
               static_cast<const int32_t*>(row_ptr), n_x, n_edges, num_rows,
               F, window, block_rows, 0, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vector ? launch<float, 4>(x, out, b, s) : launch<float, 1>(x, out, b, s);
  return vector ? launch<__nv_bfloat16, 8>(x, out, b, s)
                : launch<__nv_bfloat16, 1>(x, out, b, s);
}

const char* tgp_banded_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
