// Batched bf16 matrix product with f32 accumulation for Hopper (sm_90a).
//
//   out[i] = op_a(a[i]) @ op_b(b[i])      out: f32 [batch, n, f]
//
// op_a(a[i]) is [n, m]: a is stored [batch, n, m], or [batch, m, n] with
// TRANS_A (a^T @ b).  op_b(b[i]) is [m, f]: b is stored [batch, m, f], or
// [batch, f, m] with TRANS_B (a @ b^T).  Each operand is rounded to bf16
// (round to nearest even) as it is loaded, whatever its dtype (f32 or
// bf16); the products are summed in f32 and written in f32.
//
// Replaces the Pallas TPU kernel tgp_tpu/ops/pallas/bmm.py::_kernel
// (bmm_pallas, K3): the dense GCN's [B, N, N] @ [B, N, F] adjacency product
// and, with the transpose flags, its backward (da = g @ b^T, db = a^T @ g)
// without a transposed copy in memory.
//
// What bounds it on an H100: bytes.  At the dense regime's shapes
// ([64, 256, 256] @ [64, 256, 128]) it does 2 * n * m * f flops per matrix
// on 2 * (n * m + m * f) bytes of bf16 input: ~50 flops a byte, far below
// the card's ~295 bf16 tensor-core flops a byte.  The least traffic is one
// read of each operand and one write of the f32 output.
//
// What the design does about it: one block of four warps owns a 64 x 64
// output tile of one matrix and walks the contraction in 32-wide steps.
// Each step's A (64 x 32) and B (32 x 64) tiles are read from device memory
// once into registers, rounded to bf16 there, and staged in shared memory,
// where the four warps run WMMA 16x16x16 bf16 products into f32
// accumulators (each warp a 32 x 32 quarter).  The next step's tiles are
// loaded into registers while the current step's products run.  The
// transpose flags are template parameters and change only the index
// arithmetic of those loads (neighbouring threads read neighbouring
// addresses in either layout), so a transposed operand never exists in
// memory.  Ragged n, m and f are zero-filled on load and masked on store.
// The output goes through shared memory so every store is in bounds and
// coalesced.  A later version would use TMA and wgmma.
//
// Plain C interface (bound with ctypes); the caller allocates `out`, passes
// PyTorch's current stream, and reads the returned cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kBM = 64;  // output rows of a block
constexpr int kBN = 64;  // output columns of a block
constexpr int kBK = 32;  // contraction step
constexpr int kThreads = 128;  // four warps, 2 x 2 over the tile
constexpr int kALd = kBK + 8;  // bf16 row pitch of the A tile (WMMA: x8)
constexpr int kBLd = kBN + 8;  // bf16 row pitch of the B tile
constexpr int kCLd = kBN + 4;  // f32 row pitch of the output tile (x4)
constexpr int kAPerThread = kBM * kBK / kThreads;
constexpr int kBPerThread = kBK * kBN / kThreads;
constexpr int kTileBytes = 2 * (kBM * kALd + kBK * kBLd);
constexpr int kOutBytes = 4 * kBM * kCLd;
constexpr int kSmemBytes = kTileBytes > kOutBytes ? kTileBytes : kOutBytes;

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }

// Element t of a thread's share of a tile: (row, col) of the tile, with
// consecutive t of neighbouring threads on consecutive addresses of the
// operand as it is stored.
template <bool TRANSPOSED, int ROWS, int COLS>
__device__ __forceinline__ void tile_pos(int t, int& row, int& col) {
  if (TRANSPOSED) {  // stored column-major: rows are contiguous
    col = t / ROWS;
    row = t - col * ROWS;
  } else {
    row = t / COLS;
    col = t - row * COLS;
  }
}

template <typename TA, typename TB, bool TRANS_A, bool TRANS_B>
struct Loader {
  const TA* a;
  const TB* b;
  int n, m, f, row0, col0;

  // op_a(a)[row0 + r, k0 + c] for the thread's share of the A tile.
  __device__ __forceinline__ void load_a(int k0, __nv_bfloat16* ra) const {
#pragma unroll
    for (int i = 0; i < kAPerThread; ++i) {
      int r, c;
      tile_pos<TRANS_A, kBM, kBK>(i * kThreads + threadIdx.x, r, c);
      const int gr = row0 + r, gk = k0 + c;
      __nv_bfloat16 v = __float2bfloat16_rn(0.f);
      if (gr < n && gk < m)
        v = to_bf16(TRANS_A ? a[static_cast<size_t>(gk) * n + gr]
                            : a[static_cast<size_t>(gr) * m + gk]);
      ra[i] = v;
    }
  }

  // op_b(b)[k0 + c, col0 + j] for the thread's share of the B tile.
  __device__ __forceinline__ void load_b(int k0, __nv_bfloat16* rb) const {
#pragma unroll
    for (int i = 0; i < kBPerThread; ++i) {
      int c, j;
      tile_pos<TRANS_B, kBK, kBN>(i * kThreads + threadIdx.x, c, j);
      const int gk = k0 + c, gj = col0 + j;
      __nv_bfloat16 v = __float2bfloat16_rn(0.f);
      if (gk < m && gj < f)
        v = to_bf16(TRANS_B ? b[static_cast<size_t>(gj) * m + gk]
                            : b[static_cast<size_t>(gk) * f + gj]);
      rb[i] = v;
    }
  }
};

template <typename TA, typename TB, bool TRANS_A, bool TRANS_B>
__global__ void __launch_bounds__(kThreads)
    bmm_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
               float* __restrict__ out, int n, int m, int f) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + kBM * kALd;
  float* Cs = reinterpret_cast<float*>(smem);

  const size_t batch = blockIdx.z;
  const Loader<TA, TB, TRANS_A, TRANS_B> ld{
      a + batch * n * m, b + batch * m * f, n, m, f,
      static_cast<int>(blockIdx.y) * kBM, static_cast<int>(blockIdx.x) * kBN};
  out += batch * n * f;

  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  __nv_bfloat16 ra[kAPerThread], rb[kBPerThread];
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < kAPerThread; ++i) {
      int r, c;
      tile_pos<TRANS_A, kBM, kBK>(i * kThreads + threadIdx.x, r, c);
      As[r * kALd + c] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kBPerThread; ++i) {
      int c, j;
      tile_pos<TRANS_B, kBK, kBN>(i * kThreads + threadIdx.x, c, j);
      Bs[c * kBLd + j] = rb[i];
    }
  };

  ld.load_a(0, ra);
  ld.load_b(0, rb);
  stage();
  __syncthreads();
  for (int k0 = 0; k0 < m; k0 += kBK) {
    const bool more = k0 + kBK < m;
    if (more) {  // the next step's tiles travel while this one computes
      ld.load_a(k0 + kBK, ra);
      ld.load_b(k0 + kBK, rb);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kBLd + wn * 32 + j * 16, kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }

  // epilogue: accumulators -> shared tile -> in-bounds, coalesced stores
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kCLd + wn * 32 + j * 16,
                              acc[i][j], kCLd, wmma::mem_row_major);
  __syncthreads();
  for (int t = threadIdx.x; t < kBM * kBN; t += kThreads) {
    const int r = t / kBN, c = t - r * kBN;
    const int gr = ld.row0 + r, gc = ld.col0 + c;
    if (gr < n && gc < f) out[static_cast<size_t>(gr) * f + gc] = Cs[r * kCLd + c];
  }
}

struct Args {
  const void* a;
  const void* b;
  float* out;
  int batch, n, m, f;
  cudaStream_t stream;
};

template <typename TA, typename TB, bool TRANS_A, bool TRANS_B>
void launch(const Args& x) {
  const dim3 grid((x.f + kBN - 1) / kBN, (x.n + kBM - 1) / kBM, x.batch);
  bmm_kernel<TA, TB, TRANS_A, TRANS_B><<<grid, kThreads, 0, x.stream>>>(
      static_cast<const TA*>(x.a), static_cast<const TB*>(x.b), x.out, x.n,
      x.m, x.f);
}

template <typename TA, typename TB>
int dispatch_trans(const Args& x, int trans_a, int trans_b) {
  if (!trans_a && !trans_b) {
    launch<TA, TB, false, false>(x);
  } else if (trans_a && !trans_b) {
    launch<TA, TB, true, false>(x);
  } else if (!trans_a && trans_b) {
    launch<TA, TB, false, true>(x);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);  // both: not supported
  }
  return 0;
}

template <typename TA>
int dispatch_b(const Args& x, int b_dtype, int trans_a, int trans_b) {
  if (b_dtype == 0) return dispatch_trans<TA, float>(x, trans_a, trans_b);
  if (b_dtype == 1) return dispatch_trans<TA, __nv_bfloat16>(x, trans_a, trans_b);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// a_dtype, b_dtype: 0 = float32, 1 = bfloat16.  Shapes as above; all
// tensors contiguous, batch <= 65535.  Returns the first CUDA error
// (0 = cudaSuccess).
int tgp_bmm(const void* a, const void* b, void* out, int batch, int n, int m,
            int f, int a_dtype, int b_dtype, int trans_a, int trans_b,
            void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0 || f <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args x{a, b, static_cast<float*>(out), batch, n, m, f,
               static_cast<cudaStream_t>(stream)};
  int err;
  if (a_dtype == 0) {
    err = dispatch_b<float>(x, b_dtype, trans_a, trans_b);
  } else if (a_dtype == 1) {
    err = dispatch_b<__nv_bfloat16>(x, b_dtype, trans_a, trans_b);
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

const char* tgp_bmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
