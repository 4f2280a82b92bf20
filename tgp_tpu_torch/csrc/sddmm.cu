// Windowed SDDMM for Hopper (sm_90a): one f32 dot product per edge,
//
//   out[e] = <a[s_e, :], b[r_e, :]>   if s_e lies in [a_base[c], a_base[c] + window) below Na
//                                      and r_e in [b_base[c], b_base[c] + window) below Nb,
//   out[e] = 0                        otherwise,     with c = e / 512 (the edge's chunk).
//
// Replaces the Pallas TPU kernel _kernel / banded_sddmm_pallas of
// tgp_tpu/ops/pallas/sddmm.py (K6), run by sddmm_banded.  The TPU kernel
// copied each 512-edge chunk's two windows of a and b into VMEM and turned
// both gathers into one-hot matmuls at HIGHEST precision; the windows are
// the kernel's contract, so ids outside them give 0 here too.  A chunk's
// window start is its smallest id below N (padding ids are N), rounded down
// to 8 and clipped to [0, max(N, window) - window].
//
// What bounds it on an H100: bytes.  Two flops per element pair against
// 4 to 8 bytes read; the least traffic is the two id arrays, the f32 output
// and one read of a and b.  Gathering both rows for every edge (2 E F
// elements) reads them some 16 times each on a banded, receiver-sorted
// graph: a receiver's ~16 edges sit together, and a sender's ~16 edges are
// spread over the ~56 chunks whose windows hold it.
//
// What the design does about it: a block of 512 threads owns a run of up
// to 16 consecutive chunks (about one block an SM) and keeps the rows they
// read in two shared-memory rings, one for a (1,216 rows) and one for b
// (320 rows), which slide with the chunks.  Rows are staged 128 bytes of F
// at a time (a slice: 32 f32 or 64 bf16 values), so the block walks its
// chunks once per slice; a step takes 4 chunks.  A step needs the rows
// between its chunks' smallest and largest in-window id on each axis (its
// target, capped at the ring's size); rows already held from the previous
// step stay, and only the rows that are new are copied in (cp.async, 16
// bytes a thread, or element by element where rows are not 16-byte
// aligned).  When the next step's new rows land in slots the current step
// does not read, they are copied while it computes.  Windows that jump,
// or fall, reload the target; an id inside its window but outside the
// target (an input whose ids spread past the ring) is read from device
// memory.  So on a banded graph each row of a is read about once a block
// plus the block's first window, and each row of b about once.  Thread j
// computes edge j of each chunk: an FMA chain over the slice's eight
// 16-byte pieces, starting at piece j % 8, so the 8 threads of a
// shared-memory phase read 8 different bank groups whatever rows they
// hold.  The edges' sums stay in shared memory across the slices, added
// in slice order, and go out in one coalesced store: the order of every
// sum is fixed, so two runs give the same bits.  The window starts are
// found by the same kernel (a warp a chunk, before the first step): no
// pre-pass and no scratch.  No tensor cores: TF32 would round the
// operands.
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
constexpr int kThreads = 512;           // a thread an edge of each chunk
constexpr int kChunkEdges = 512;        // the contract's window chunk
constexpr int kSpan = 4;     // chunks a step
constexpr int kSliceBytes = 128;        // the part of a row staged at a time
constexpr int kRingA = 1216;            // rows of a's ring
constexpr int kRingB = 320;             // rows of b's ring
constexpr int kMaxChunksPerBlock = 16;
constexpr int kInfo = 6;  // a_base, b_base, a target [lo, hi), b target [lo, hi)
constexpr int kStepInfo = 4;  // a step's targets: a [lo, hi), b [lo, hi)
constexpr int kSmemBytes =
    (kRingA + kRingB) * kSliceBytes +
    kMaxChunksPerBlock * (kChunkEdges + kInfo + kStepInfo) * 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ int warp_min(int v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Rounded down to a multiple of 8, then clipped to [0, max(n_pad - window, 0)].
__device__ __forceinline__ int window_start(int m, int n_pad, int window) {
  const int floor8 = (m >= 0 ? m / 8 : -((-m + 7) / 8)) * 8;
  return min(max(floor8, 0), max(n_pad - window, 0));
}

// Chunk i of the block (global chunk c0 + i), one warp a chunk: its window
// starts (the smallest id below N on each axis, n_pad = max(N, window) when
// there is none), then the rows its in-window edges read on each axis,
// [smallest, largest + 1) (empty when no edge is in both windows).
__device__ void chunk_info(const int32_t* __restrict__ senders,
                           const int32_t* __restrict__ receivers, int* info,
                           int c0, int nch, int E, int Na, int Nb,
                           int window) {
  const int lane = threadIdx.x % kWarp;
  const int na_pad = max(Na, window), nb_pad = max(Nb, window);
  constexpr int kPerLane = kChunkEdges / kWarp;
  for (int i = threadIdx.x / kWarp; i < nch; i += kThreads / kWarp) {
    const int lo = (c0 + i) * kChunkEdges, hi = min(lo + kChunkEdges, E);
    int sv[kPerLane], rv[kPerLane];  // Na / Nb past the last edge
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int e = lo + lane + u * kWarp;
      sv[u] = e < hi ? senders[e] : Na;
      rv[u] = e < hi ? receivers[e] : Nb;
    }
    int ma = na_pad, mb = nb_pad;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      if (sv[u] < Na) ma = min(ma, sv[u]);
      if (rv[u] < Nb) mb = min(mb, rv[u]);
    }
    const int a_lo = window_start(warp_min(ma), na_pad, window);
    const int b_lo = window_start(warp_min(mb), nb_pad, window);
    const int a_hi = min(a_lo + window, Na), b_hi = min(b_lo + window, Nb);
    int s_min = INT_MAX, s_max = INT_MIN, r_min = INT_MAX, r_max = INT_MIN;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      if (sv[u] >= a_lo && sv[u] < a_hi && rv[u] >= b_lo && rv[u] < b_hi) {
        s_min = min(s_min, sv[u]);
        s_max = max(s_max, sv[u]);
        r_min = min(r_min, rv[u]);
        r_max = max(r_max, rv[u]);
      }
    }
    s_min = warp_min(s_min);
    s_max = warp_max(s_max);
    r_min = warp_min(r_min);
    r_max = warp_max(r_max);
    if (lane == 0) {
      int* in = info + i * kInfo;
      const bool any = s_min <= s_max;
      in[0] = a_lo;
      in[1] = b_lo;
      in[2] = any ? s_min : 0;
      in[3] = any ? s_max + 1 : 0;
      in[4] = any ? r_min : 0;
      in[5] = any ? r_max + 1 : 0;
    }
  }
}

// Rows [lo, hi) of a matrix held in a ring, row x in slot x % cap.
struct Ring {
  int lo, hi;
};

// What to copy so that a ring holding `cur` holds the target [t_lo, t_hi)
// (t_hi - t_lo <= cap): when the target starts inside what is held, the
// rows past its end; else the whole target.  Returns the rows to copy in
// [*load_lo, *load_hi) and updates `cur`.
__device__ __forceinline__ void plan(Ring& cur, int t_lo, int t_hi, int cap,
                                     int* load_lo, int* load_hi) {
  if (t_lo >= t_hi) {  // nothing read from the ring
    *load_lo = *load_hi = 0;
  } else if (t_lo >= cur.lo && t_lo <= cur.hi) {
    *load_lo = cur.hi;
    *load_hi = max(cur.hi, t_hi);
    cur.hi = *load_hi;
    cur.lo = max(cur.lo, cur.hi - cap);
  } else {
    *load_lo = cur.lo = t_lo;
    *load_hi = cur.hi = t_hi;
  }
}

// Copying rows [lo, hi) into a ring of `cap` slots cannot touch a slot
// that the current step reads (its target [c_lo, c_hi)).
__device__ __forceinline__ bool disjoint(int lo, int hi, int c_lo, int c_hi,
                                         int cap) {
  return lo >= hi || c_lo >= c_hi || (lo >= c_hi && hi <= c_lo + cap);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Columns [f0, f0 + w) of rows [lo, hi) of x [*, F] into the ring; VEC > 1:
// 16-byte asynchronous copies (rows 16-byte aligned), else element copies.
template <typename T, int VEC, int CAP>
__device__ __forceinline__ void load_rows(unsigned char* ring,
                                          const T* __restrict__ x, int lo,
                                          int hi, int F, int f0, int w) {
  const int per_row = w / VEC;
  const int n = (hi - lo) * per_row;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int row = lo + i / per_row, q = i % per_row;
    const T* src = x + static_cast<size_t>(row) * F + f0 + q * VEC;
    T* dst = reinterpret_cast<T*>(ring + (row % CAP) * kSliceBytes) +
             q * VEC;
    if constexpr (VEC > 1)
      cp_async16(dst, src);
    else
      *dst = *src;
  }
}


template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
    sddmm_ring_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const int32_t* __restrict__ senders,
                      const int32_t* __restrict__ receivers,
                      float* __restrict__ out, int E, int Na, int Nb, int F,
                      int window, int n_chunks, int per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring_a = smem;
  unsigned char* ring_b = smem + kRingA * kSliceBytes;
  float* part = reinterpret_cast<float*>(ring_b + kRingB * kSliceBytes);
  int* info = reinterpret_cast<int*>(part + kMaxChunksPerBlock * kChunkEdges);
  int* step_info = info + kMaxChunksPerBlock * kInfo;
  constexpr int kSlice = kSliceBytes / static_cast<int>(sizeof(T));
  const int tid = threadIdx.x;  // this thread's edge of each chunk

  const int c0 = blockIdx.x * per_block;
  const int nch = min(per_block, n_chunks - c0);
  const int spans = (nch + kSpan - 1) / kSpan;  // steps a slice
  for (int j = threadIdx.x; j < nch * kChunkEdges; j += kThreads) part[j] = 0.f;
  chunk_info(senders, receivers, info, c0, nch, E, Na, Nb, window);
  __syncthreads();
  // a step's targets: the union of its chunks', capped at the rings' sizes
  if (threadIdx.x < spans) {
    const int j = threadIdx.x;
    int al = INT_MAX, ah = INT_MIN, bl = INT_MAX, bh = INT_MIN;
    for (int i = j * kSpan; i < min(j * kSpan + kSpan, nch); ++i) {
      const int* in = info + i * kInfo;
      if (in[2] < in[3]) {
        al = min(al, in[2]);
        ah = max(ah, in[3]);
        bl = min(bl, in[4]);
        bh = max(bh, in[5]);
      }
    }
    int* st = step_info + j * kStepInfo;
    const bool any = al <= ah;
    st[0] = any ? al : 0;
    st[1] = any ? min(ah, al + kRingA) : 0;
    st[2] = any ? bl : 0;
    st[3] = any ? min(bh, bl + kRingB) : 0;
  }
  __syncthreads();

  const int steps = (F + kSlice - 1) / kSlice * spans;  // slice-major
  Ring ra{0, 0}, rb{0, 0};
  int la_lo, la_hi, lb_lo, lb_hi;  // the next step's copies
  auto plan_step = [&](int t) {
    const int j = t % spans;
    if (j == 0) ra = rb = Ring{0, 0};  // a new slice: nothing held
    const int* st = step_info + j * kStepInfo;
    plan(ra, st[0], st[1], kRingA, &la_lo, &la_hi);
    plan(rb, st[2], st[3], kRingB, &lb_lo, &lb_hi);
  };
  auto issue = [&](int t) {
    const int f0 = t / spans * kSlice, w = min(kSlice, F - f0);
    load_rows<T, VEC, kRingA>(ring_a, a, la_lo, la_hi, F, f0, w);
    load_rows<T, VEC, kRingB>(ring_b, b, lb_lo, lb_hi, F, f0, w);
    if constexpr (VEC > 1) asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // the ids of the edges this thread loads for step t (INT_MIN: no edge)
  auto load_ids = [&](int t, int* s_out, int* r_out) {
#pragma unroll
    for (int c = 0; c < kSpan; ++c) {
      const int i = t % spans * kSpan + c;
      const int e = (c0 + i) * kChunkEdges + tid;
      const bool ok = t < steps && i < nch && e < E;
      s_out[c] = ok ? senders[e] : INT_MIN;
      r_out[c] = ok ? receivers[e] : INT_MIN;
    }
  };

  plan_step(0);
  issue(0);
  int my_s[kSpan], my_r[kSpan];
  load_ids(0, my_s, my_r);
  for (int t = 0; t < steps; ++t) {
    const int j = t % spans, f0 = t / spans * kSlice, w = min(kSlice, F - f0);
    int next_s[kSpan], next_r[kSpan];
    load_ids(t + 1, next_s, next_r);
    if constexpr (VEC > 1) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the rings hold this step's targets

    const int* st = step_info + j * kStepInfo;
    const int ta_lo = st[0], ta_hi = st[1], tb_lo = st[2], tb_hi = st[3];
    bool early = false;
    if (t + 1 < steps) {
      plan_step(t + 1);
      early = disjoint(la_lo, la_hi, ta_lo, ta_hi, kRingA) &&
              disjoint(lb_lo, lb_hi, tb_lo, tb_hi, kRingB);
      if (early) issue(t + 1);  // overlaps this step's products
    }
    // This thread's edge of each chunk of the step: an FMA chain over the
    // slice, its 16-byte pieces taken from piece tid % 8 on, so that the
    // 8 threads of a shared-memory phase read 8 different bank groups
    // whatever rows they hold; the slice's dot is added to the edge's sum.
    constexpr int kPieces = kSliceBytes / 16;
#pragma unroll
    for (int c = 0; c < kSpan; ++c) {
      const int i = j * kSpan + c;
      if (i >= nch) break;  // uniform across the block
      const int* in = info + i * kInfo;
      const int sv = my_s[c], rv = my_r[c];
      if (!(sv >= in[0] && sv < min(in[0] + window, Na) && rv >= in[1] &&
            rv < min(in[1] + window, Nb)))
        continue;
      const bool a_in = sv >= ta_lo && sv < ta_hi, b_in = rv >= tb_lo && rv < tb_hi;
      float dot = 0.f;
      if (VEC > 1 && a_in && b_in && w == kSlice) {  // the rings: shared loads
        const Pack<T, VEC>* xa =
            reinterpret_cast<const Pack<T, VEC>*>(ring_a + sv % kRingA * kSliceBytes);
        const Pack<T, VEC>* xb =
            reinterpret_cast<const Pack<T, VEC>*>(ring_b + rv % kRingB * kSliceBytes);
#pragma unroll
        for (int q = 0; q < kPieces; ++q) {
          const int qq = (q + tid) % kPieces;
          const Pack<T, VEC> x = xa[qq], y = xb[qq];
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            dot = fmaf(to_float(x.v[k]), to_float(y.v[k]), dot);
        }
      } else {  // a row outside the rings, a short last slice, or no vectors
        const T* xa = a_in ? reinterpret_cast<const T*>(ring_a + sv % kRingA * kSliceBytes)
                           : a + static_cast<size_t>(sv) * F + f0;
        const T* xb = b_in ? reinterpret_cast<const T*>(ring_b + rv % kRingB * kSliceBytes)
                           : b + static_cast<size_t>(rv) * F + f0;
        for (int q = 0; q < w; ++q) dot = fmaf(to_float(xa[q]), to_float(xb[q]), dot);
      }
      part[i * kChunkEdges + tid] += dot;
    }
    if (t + 1 < steps && !early) {
      __syncthreads();  // every thread is done with the slots it overwrites
      issue(t + 1);
    }
#pragma unroll
    for (int c = 0; c < kSpan; ++c) {
      my_s[c] = next_s[c];
      my_r[c] = next_r[c];
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < nch * kChunkEdges; q += kThreads)
    if (c0 * kChunkEdges + q < E) out[c0 * kChunkEdges + q] = part[q];
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

struct Args {
  const void *a, *b, *senders, *receivers;
  void* out;
  int E, Na, Nb, F, window;
  cudaStream_t stream;
};

template <typename T, int VEC>
int launch(const Args& p) {
  static std::atomic<uint64_t> raised{0};
  auto kernel = sddmm_ring_kernel<T, VEC>;
  int err = raise_smem_limit(kernel, raised);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // about one block an SM (the rings fill the SM's shared memory)
  const int n_chunks = (p.E + kChunkEdges - 1) / kChunkEdges;
  const int per_block =
      min(max((n_chunks + sms - 1) / sms, 1), kMaxChunksPerBlock);
  const int blocks = (n_chunks + per_block - 1) / per_block;
  kernel<<<blocks, kThreads, kSmemBytes, p.stream>>>(
      static_cast<const T*>(p.a), static_cast<const T*>(p.b),
      static_cast<const int32_t*>(p.senders),
      static_cast<const int32_t*>(p.receivers), static_cast<float*>(p.out),
      p.E, p.Na, p.Nb, p.F, p.window, n_chunks, per_block);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte copies and loads where every row's slices start 16-byte aligned.
template <typename T>
int dispatch(const Args& p) {
  const bool aligned =
      (static_cast<size_t>(p.F) * sizeof(T)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(p.a) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(p.b) % 16 == 0;
  return aligned ? launch<T, 16 / sizeof(T)>(p) : launch<T, 1>(p);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a and b alike); out is f32 [E];
// chunk_edges must be 512.  Returns the first CUDA error (0 = cudaSuccess).
int tgp_sddmm(const void* a, const void* b, const void* senders,
              const void* receivers, void* out, int E, int Na, int Nb, int F,
              int window, int chunk_edges, int dtype, void* stream) {
  if (E <= 0 || F <= 0 || Na < 0 || Nb < 0 || window <= 0 ||
      chunk_edges != kChunkEdges)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{a, b, senders, receivers, out, E, Na, Nb, F, window,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(p);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p);
  return static_cast<int>(cudaErrorInvalidValue);
}


const char* tgp_sddmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
