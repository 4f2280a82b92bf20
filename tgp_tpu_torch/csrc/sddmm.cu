// Windowed SDDMM for Hopper (sm_90a): one f32 dot product per edge,
//
//   out[e] = <a[s_e, :], b[r_e, :]>   if s_e lies in [a_base[c], a_base[c] + window) below Na
//                                      and r_e in [b_base[c], b_base[c] + window) below Nb,
//   out[e] = 0                        otherwise,     with c = e / chunk_edges.
//
// Replaces the Pallas TPU kernel _kernel / banded_sddmm_pallas of
// tgp_tpu/ops/pallas/sddmm.py (K6), run by sddmm_banded.  The TPU kernel
// copied each 512-edge chunk's two windows of a and b into VMEM and turned
// both gathers into one-hot matmuls at HIGHEST precision; the windows are
// the kernel's contract, so ids outside them give 0 here too.
//
// What bounds it on an H100: bytes.  Two flops per element pair against
// 4 to 8 bytes read; the least traffic is the two id arrays, the f32 output
// and one read of a and b.  The gathered rows (2 E F elements) come from L2
// when a and b fit in its 50 MB.
//
// What the design does about it: one warp per edge.  The lanes split the
// row into 16-byte vectors (VEC elements), so a row of 128 f32 values is one
// load per lane from a and one from b, multiplied and summed in f32
// registers, then reduced across the warp by shuffles.  No [E, F] gathered
// rows are written, and an edge outside its windows loads nothing.  A first,
// small kernel finds each chunk's two window starts (one thread block per
// chunk, a min over its ids), so the wrapper adds no PyTorch ops of its own.
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

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Block-wide min of v; the result is valid in thread 0.
__device__ __forceinline__ int block_min(int v, int* warp_min) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  if ((threadIdx.x & (kWarp - 1)) == 0) warp_min[threadIdx.x / kWarp] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < kWarpsPerBlock; ++k) v = min(v, warp_min[k]);
  return v;
}

// Rounded down to a multiple of 8, then clipped to [0, max(n_pad - window, 0)].
__device__ __forceinline__ int window_start(int m, int n_pad, int window) {
  const int floor8 = (m >= 0 ? m / 8 : -((-m + 7) / 8)) * 8;
  return min(max(floor8, 0), max(n_pad - window, 0));
}

// Chunk c's window starts, as banded_sddmm_pallas computes them: on each
// axis the smallest id below N among the chunk's edges (n_pad = max(N,
// window) when there is none), rounded down to 8 and clipped.
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    chunk_base_kernel(const int32_t* __restrict__ senders,
                      const int32_t* __restrict__ receivers,
                      int32_t* __restrict__ a_base, int32_t* __restrict__ b_base,
                      int E, int Na, int Nb, int window, int chunk_edges) {
  __shared__ int warp_min[2][kWarpsPerBlock];
  const int c = blockIdx.x;
  const int na_pad = max(Na, window), nb_pad = max(Nb, window);
  const int lo = c * chunk_edges, hi = min(lo + chunk_edges, E);
  int ma = na_pad, mb = nb_pad;
  for (int e = lo + static_cast<int>(threadIdx.x); e < hi; e += blockDim.x) {
    const int s = senders[e], r = receivers[e];
    if (s < Na) ma = min(ma, s);
    if (r < Nb) mb = min(mb, r);
  }
  ma = block_min(ma, warp_min[0]);
  mb = block_min(mb, warp_min[1]);
  if (threadIdx.x == 0) {
    a_base[c] = window_start(ma, na_pad, window);
    b_base[c] = window_start(mb, nb_pad, window);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    sddmm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const int32_t* __restrict__ senders,
                 const int32_t* __restrict__ receivers,
                 const int32_t* __restrict__ a_base,
                 const int32_t* __restrict__ b_base, float* __restrict__ out,
                 int E, int Na, int Nb, int F, int window, int chunk_edges) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long e_ll =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (e_ll >= E) return;
  const int e = static_cast<int>(e_ll);
  const int c = e / chunk_edges;
  const int s = senders[e], r = receivers[e];
  const int a_lo = a_base[c], b_lo = b_base[c];
  const bool valid = s >= a_lo && s < min(a_lo + window, Na) && r >= b_lo &&
                     r < min(b_lo + window, Nb);
  if (!valid) {  // uniform across the warp
    if (lane == 0) out[e] = 0.f;
    return;
  }
  const T* a_row = a + static_cast<size_t>(s) * F;
  const T* b_row = b + static_cast<size_t>(r) * F;
  float acc = 0.f;
  for (int k = lane; k < F / VEC; k += kWarp) {
    const Pack<T, VEC> pa = *reinterpret_cast<const Pack<T, VEC>*>(a_row + k * VEC);
    const Pack<T, VEC> pb = *reinterpret_cast<const Pack<T, VEC>*>(b_row + k * VEC);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc = fmaf(to_float(pa.v[j]), to_float(pb.v[j]), acc);
  }
  for (int off = kWarp / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) out[e] = acc;
}

// Widest vector (at most 16 bytes) that divides F and both base pointers'
// alignment.
template <typename T>
int pick_vec(const void* a, const void* b, int F) {
  for (int vec = 16 / static_cast<int>(sizeof(T)); vec > 1; vec /= 2) {
    const uintptr_t bytes = static_cast<uintptr_t>(vec) * sizeof(T);
    if (F % vec == 0 && reinterpret_cast<uintptr_t>(a) % bytes == 0 &&
        reinterpret_cast<uintptr_t>(b) % bytes == 0)
      return vec;
  }
  return 1;
}

struct Args {
  const void *a, *b, *senders, *receivers, *a_base, *b_base;
  void* out;
  int E, Na, Nb, F, window, chunk_edges;
  cudaStream_t stream;
};

template <typename T, int VEC>
void launch(const Args& p) {
  const long long blocks = (static_cast<long long>(p.E) + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sddmm_kernel<T, VEC><<<static_cast<unsigned>(blocks), kWarp * kWarpsPerBlock, 0, p.stream>>>(
      static_cast<const T*>(p.a), static_cast<const T*>(p.b),
      static_cast<const int32_t*>(p.senders), static_cast<const int32_t*>(p.receivers),
      static_cast<const int32_t*>(p.a_base), static_cast<const int32_t*>(p.b_base),
      static_cast<float*>(p.out), p.E, p.Na, p.Nb, p.F, p.window, p.chunk_edges);
}

template <typename T>
void dispatch(const Args& p) {
  switch (pick_vec<T>(p.a, p.b, p.F)) {
    case 8:
      launch<T, 8>(p);
      break;
    case 4:
      launch<T, 4>(p);
      break;
    case 2:
      launch<T, 2>(p);
      break;
    default:
      launch<T, 1>(p);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a and b alike); out is f32 [E].
// a_base, b_base: int32 [ceil(E / chunk_edges)] window starts, written here
// before the products.
// Returns the first CUDA error (0 = cudaSuccess).
int tgp_sddmm(const void* a, const void* b, const void* senders,
              const void* receivers, void* a_base, void* b_base, void* out,
              int E, int Na, int Nb, int F, int window, int chunk_edges,
              int dtype, void* stream) {
  if (E <= 0 || F <= 0 || window <= 0 || chunk_edges <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{a, b, senders, receivers, a_base, b_base, out, E, Na, Nb, F,
               window, chunk_edges, static_cast<cudaStream_t>(stream)};
  chunk_base_kernel<<<(E + chunk_edges - 1) / chunk_edges,
                      kWarp * kWarpsPerBlock, 0, p.stream>>>(
      static_cast<const int32_t*>(senders),
      static_cast<const int32_t*>(receivers), static_cast<int32_t*>(a_base),
      static_cast<int32_t*>(b_base), E, Na, Nb, window, chunk_edges);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0) {
    dispatch<float>(p);
  } else if (dtype == 1) {
    dispatch<__nv_bfloat16>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tgp_sddmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
