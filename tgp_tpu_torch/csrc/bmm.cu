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
// Replaces the Pallas TPU kernel tgp_tpu/ops/pallas/bmm.py:37 (_kernel of
// bmm_pallas, K3): the dense GCN's [B, N, N] @ [B, N, F] adjacency product
// and, with the transpose flags, its backward (da = g @ b^T, db = a^T @ g)
// without a transposed copy in memory.
//
// What bounds it on an H100: bytes.  It does 2 * n * m * f flops per matrix
// and must read each operand once and write the f32 output once.  At the
// dense regime's shapes that is 51 flops a byte for [64, 256, 256] @
// [64, 256, 128] in bf16, 43 for the backward a^T @ g with an f32 g, and
// 32 for the post-pool [64, 128, 128] @ [64, 128, 128]: all far below the
// card's ~295 bf16 tensor-core flops a byte.  So the design is about bytes
// in flight and wide, asynchronous copies.
//
// Two routes, chosen by the caller (tgp_tpu_torch/ops/kernels/bmm.py::route,
// a pure function of shapes, dtypes, flags and base-pointer alignment):
//
// "tma" (bmm_tma_kernel), for operands whose bases are 16-byte aligned and
// whose stored rows are a multiple of 16 bytes (bf16 inner extent % 8, f32
// % 4) and an output width f % 4 == 0:
//  - A block owns a 64 x 128 output tile of one matrix and walks the
//    contraction in 64-deep steps through a ring of 4 shared-memory
//    stages.  Each stage holds the step's A and B tiles as 64 x 64 bf16
//    boxes of 128-byte rows in the 128-byte swizzle (16-byte chunk c of
//    row r at chunk c ^ (r % 8)), so a box is 8 KB and a stage 24 KB:
//    96 KB in flight per block, two blocks an SM.  (128-row tiles, two
//    consumer warpgroups a block, measured slower in four of the five
//    modes and were not kept.)
//  - Full and empty mbarriers guard each stage.  One producer warp issues
//    TMA loads (cp.async.bulk.tensor, 3-D maps over (batch, rows, cols),
//    so a box never crosses into the next matrix); TMA zero-fills out of
//    bounds, so ragged n, m and f need no masks.
//  - Operand layouts are template parameters, never copies: a box is cut
//    along the operand's stored rows, and wgmma reads it K-major or
//    MN-major by its transpose immediates.  nn: A = a[n, m] K-major, B =
//    b[m, f] MN-major.  trans_a: A = a[m, n] MN-major.  trans_b: B =
//    b[f, m] K-major.  K-major descriptors step 32 bytes per k16 inside a
//    swizzled row (stride byte offset 1024 between 8-row groups);
//    MN-major ones step 2048 bytes (16 rows), with the leading byte offset
//    8192 between the two 64-wide halves of B's 128 columns.
//  - An f32 operand (the cotangent g of the backward, an f32 h) cannot be
//    converted by TMA: then the producer is a warpgroup that reads it with
//    16-byte loads, masked by hand, rounds to bf16 (RNE) and writes the
//    same swizzled layout, then fences (fence.proxy.async) before it
//    arrives on the stage's full barrier, so wgmma (the async proxy) sees
//    the stores.
//  - One consumer warpgroup runs wgmma.mma_async m64n128k16 (bf16 in, 64
//    f32 accumulators a thread), four a step, keeps one step's group in
//    flight and releases a stage when its group has retired.
//  - Epilogue: the accumulators go into a drained stage as 32-column f32
//    boxes in the 128-byte swizzle (conflict-free 8-byte stores), and one
//    thread writes them with TMA stores, which clip ragged rows and
//    columns.
//
// "generic" (bmm_kernel), for everything else: WMMA 16x16x16 on 64 x 64
// tiles, 32-deep steps staged through registers, element loads with
// bounds checks (zero fill) and masked, coalesced stores through shared
// memory.
//
// Plain C interface (bound with ctypes); the caller allocates `out`, passes
// PyTorch's current stream, and reads the returned cudaError_t.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <atomic>
#include <cstdint>

namespace {

using namespace nvcuda;

// ---------------------------------------------------------------------------
// "generic" route: WMMA on register-staged tiles
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// "tma" route: TMA ring, mbarriers, wgmma
// ---------------------------------------------------------------------------

constexpr int kBox = 64 * 128;  // bytes of a 64-row box of 128-byte rows
constexpr int kStep = 64;       // contraction step (a box's bf16 width)
constexpr int kTileN = 128;     // output columns of a block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of the given parity has completed.  A
// wait that outlasts ~2^34 cycles (seconds) traps, so a broken protocol
// ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = -1;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) start = now;
    if (now - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A shared-memory matrix descriptor for wgmma in the 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Pins the accumulators in registers around asynchronous wgmma (the
// compiler must not move them while a group may still write them).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] B[16 x 128], both from shared memory; TNSP_A /
// TNSP_B = 1 reads that operand MN-major.
template <int TNSP_A, int TNSP_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TNSP_A), "n"(TNSP_B));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A read-only 16-byte load, volatile so that the compiler keeps one
// operand's loads after the other operand's stores (with both f32 it
// would overlap them and spill).
__device__ __forceinline__ float4 ld_f32x4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// NBOX 64 x 64 boxes of an f32 matrix stored [outer, inner] (row pitch
// `inner`), box j at (inner0 + j * d_inner, outer0 + j * d_outer), rounded
// to bf16 into the 128-byte-swizzled layout a TMA box of the same place
// would have at `dst + j * kBox`; out-of-bounds elements are 0.  Each of
// the 128 producer threads moves two 16-byte bf16 chunks (16 f32) of two
// rows a box, read as 16-byte f32 loads: four threads cover a 256-byte
// row segment.  inner is a multiple of 4, so a load is wholly in or out of
// bounds.
template <int NBOX>
__device__ __forceinline__ void convert_group(const float* __restrict__ src,
                                              int inner, int outer, int inner0,
                                              int outer0, int d_inner,
                                              int d_outer, uint32_t dst,
                                              int pt) {
  // rows r0 and r0 + 32, chunks c0 and c0 + 1
  const int r0 = pt >> 2, c0 = (pt & 3) * 2;
  float4 v[NBOX][2][4];
#pragma unroll
  for (int j = 0; j < NBOX; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int go = outer0 + j * d_outer + r0 + 32 * u;
      const int gi = inner0 + j * d_inner + c0 * 8;
      const float* p = src + static_cast<size_t>(go) * inner + gi;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        v[j][u][t] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (go < outer && gi + 4 * t < inner) v[j][u][t] = ld_f32x4(p + 4 * t);
      }
    }
#pragma unroll
  for (int j = 0; j < NBOX; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 32 * u, c = c0 + h;
        const float4 x = v[j][u][2 * h], y = v[j][u][2 * h + 1];
        const uint32_t addr = dst + j * kBox + r * 128 + ((c ^ (r & 7)) << 4);
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
                     "r"(pack_bf16x2(x.x, x.y)), "r"(pack_bf16x2(x.z, x.w)),
                     "r"(pack_bf16x2(y.x, y.y)), "r"(pack_bf16x2(y.z, y.w))
                     : "memory");
      }
}

// NBOX boxes of an f32 operand, GROUP boxes loaded before their stores:
// all of them when one operand is f32 (bytes in flight), one at a time when
// both are (which would spill otherwise).
template <int NBOX, int GROUP>
__device__ __forceinline__ void convert_boxes(const float* __restrict__ src,
                                              int inner, int outer, int inner0,
                                              int outer0, int d_inner,
                                              int d_outer, uint32_t dst,
                                              int pt) {
#pragma unroll
  for (int j0 = 0; j0 < NBOX; j0 += GROUP)
    convert_group<GROUP>(src, inner, outer, inner0 + j0 * d_inner,
                         outer0 + j0 * d_outer, d_inner, d_outer,
                         dst + j0 * kBox, pt);
}

// A_F32 / B_F32: that operand is f32 (converted by the producer warpgroup)
// rather than bf16 (loaded by TMA).  A_MN: A is stored [m, n] (trans_a).
// B_K: B is stored [f, m] (trans_b).
template <bool A_F32, bool B_F32>
struct TmaCfg {
  static constexpr int kConsumers = 128;  // one warpgroup, 64 output rows
  static constexpr bool kConvert = A_F32 || B_F32;
  static constexpr int kProducers = kConvert ? 128 : 32;
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int kStages = 4;
  static constexpr int kStageBytes = 3 * kBox;  // A box, B's two boxes
  static constexpr uint32_t kTxBytes =
      (A_F32 ? 0 : kBox) + (B_F32 ? 0 : 2 * kBox);
  // full barrier: the TMA thread's arrive.expect_tx, then every converting
  // thread's arrive after its stores
  static constexpr int kFullCount =
      (kTxBytes ? 1 : 0) + (kConvert ? kProducers : 0);
  static constexpr int kOutBytes = 4 * kBox;  // 32-column f32 boxes
  static constexpr int kRingBytes = kStages * kStageBytes;
  static_assert(kOutBytes <= kRingBytes, "the output tile reuses the ring");
  static constexpr int kSmem = kRingBytes + 2 * kStages * 8 + 1024;
};

template <bool A_F32, bool B_F32, bool A_MN, bool B_K>
__global__ void __launch_bounds__(TmaCfg<A_F32, B_F32>::kThreads, 2)
    bmm_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   const __grid_constant__ CUtensorMap map_out,
                   const float* __restrict__ a32,
                   const float* __restrict__ b32, int n, int m, int f) {
  using C = TmaCfg<A_F32, B_F32>;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the swizzle pattern repeats every 8 rows of 128 B
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + C::kRingBytes;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bars + 8 * s, C::kFullCount);      // full[s]
      mbar_init(bars + 8 * (C::kStages + s), 1);   // empty[s]
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int row0 = blockIdx.y * 64, col0 = blockIdx.x * kTileN;
  const int batch = blockIdx.z;
  const int steps = (m + kStep - 1) / kStep;

  if (tid >= C::kConsumers) {  // producer
    const int pt = tid - C::kConsumers;
    if (!C::kConvert && pt != 0) return;
    for (int ks = 0; ks < steps; ++ks) {
      const int s = ks % C::kStages;
      const uint32_t full = bars + 8 * s;
      mbar_wait(bars + 8 * (C::kStages + s), ((ks / C::kStages) & 1) ^ 1);
      const uint32_t sa = base + s * C::kStageBytes, sb = sa + kBox;
      const int k0 = ks * kStep;
      if (C::kTxBytes && pt == 0) {
        mbar_arrive_tx(full, C::kTxBytes);
        if (!A_F32)
          A_MN ? tma_load(sa, &map_a, full, row0, k0, batch)
               : tma_load(sa, &map_a, full, k0, row0, batch);
        if (!B_F32)
          for (int j = 0; j < 2; ++j)
            B_K ? tma_load(sb + j * kBox, &map_b, full, k0, col0 + 64 * j,
                           batch)
                : tma_load(sb + j * kBox, &map_b, full, col0 + 64 * j, k0,
                           batch);
      }
      if (C::kConvert) {
        if (A_F32)
          convert_group<1>(a32 + static_cast<size_t>(batch) * n * m,
                           A_MN ? n : m, A_MN ? m : n, A_MN ? row0 : k0,
                           A_MN ? k0 : row0, 0, 0, sa, pt);
        if (B_F32) {
          // with both f32 and B K-major both operands' masks test k0 + c
          // against m: fresh copies keep the compiler from holding A's
          // masks live through B's conversion (which spills)
          int kb = k0, mb = m;
          asm volatile("" : "+r"(kb), "+r"(mb));
          convert_boxes<2, A_F32 ? 1 : 2>(
              b32 + static_cast<size_t>(batch) * m * f, B_K ? mb : f,
              B_K ? f : mb, B_K ? kb : col0, B_K ? col0 : kb, B_K ? 0 : 64,
              B_K ? 64 : 0, sb, pt);
        }
        fence_proxy_async();
        mbar_arrive(full);
      }
    }
    return;
  }

  // consumer warpgroup: output rows row0 ... row0 + 63
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_acc(acc);
  for (int ks = 0; ks < steps; ++ks) {
    const int s = ks % C::kStages;
    mbar_wait(bars + 8 * s, (ks / C::kStages) & 1);
    const uint32_t sa = base + s * C::kStageBytes, sb = sa + kBox;
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
      // K-major: 16 bf16 = 32 bytes along a swizzled row; MN-major: 16 rows
      const uint64_t da = A_MN ? smem_desc(sa + kk * 2048, kBox, 1024)
                               : smem_desc(sa + kk * 32, 16, 1024);
      const uint64_t db = B_K ? smem_desc(sb + kk * 32, 16, 1024)
                              : smem_desc(sb + kk * 2048, kBox, 1024);
      wgmma_m64n128k16<A_MN ? 1 : 0, B_K ? 0 : 1>(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    fence_acc(acc);
    if (ks > 0) {  // the previous step's products are done: free its stage
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(acc);
      if (tid == 0)
        mbar_arrive(bars + 8 * (C::kStages + (ks - 1) % C::kStages));
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);

  // epilogue: every load has landed and every product retired, so the ring
  // is free once all consumer warps are here
  asm volatile("bar.sync 1, %0;" ::"n"(C::kConsumers) : "memory");
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = warp * 16 + ((i >> 1) & 1) * 8 + lane / 4;
    const int c = (i >> 2) * 8 + (lane % 4) * 2;
    const int cc = c & 31;
    const uint32_t addr = base + (c >> 5) * kBox + r * 128 +
                          (((cc >> 2) ^ (r & 7)) << 4) + (cc & 3) * 4;
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr),
                 "f"(acc[i]), "f"(acc[i + 1])
                 : "memory");
  }
  fence_proxy_async();
  asm volatile("bar.sync 1, %0;" ::"n"(C::kConsumers) : "memory");
  if (tid == 0) {
    for (int cb = 0; cb < 4; ++cb)
      if (col0 + 32 * cb < f)
        tma_store(&map_out, base + cb * kBox, col0 + 32 * cb, row0, batch);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
  const void* a;
  const void* b;
  float* out;
  int batch, n, m, f;
  cudaStream_t stream;
};

template <typename TA, typename TB, bool TRANS_A, bool TRANS_B>
int launch(const Args& x) {
  const dim3 grid((x.f + kBN - 1) / kBN, (x.n + kBM - 1) / kBM, x.batch);
  bmm_kernel<TA, TB, TRANS_A, TRANS_B><<<grid, kThreads, 0, x.stream>>>(
      static_cast<const TA*>(x.a), static_cast<const TB*>(x.b), x.out, x.n,
      x.m, x.f);
  return 0;
}

template <typename TA, typename TB>
int dispatch_trans(const Args& x, int trans_a, int trans_b) {
  if (!trans_a && !trans_b) return launch<TA, TB, false, false>(x);
  if (trans_a && !trans_b) return launch<TA, TB, true, false>(x);
  if (!trans_a && trans_b) return launch<TA, TB, false, true>(x);
  return static_cast<int>(cudaErrorInvalidValue);  // both: not supported
}

template <typename TA>
int dispatch_b(const Args& x, int b_dtype, int trans_a, int trans_b) {
  if (b_dtype == 0) return dispatch_trans<TA, float>(x, trans_a, trans_b);
  if (b_dtype == 1)
    return dispatch_trans<TA, __nv_bfloat16>(x, trans_a, trans_b);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_generic(const Args& x, int a_dtype, int b_dtype, int trans_a,
                     int trans_b) {
  if (a_dtype == 0) return dispatch_b<float>(x, b_dtype, trans_a, trans_b);
  if (a_dtype == 1)
    return dispatch_b<__nv_bfloat16>(x, b_dtype, trans_a, trans_b);
  return static_cast<int>(cudaErrorInvalidValue);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found once through the runtime's
// entry-point query (no link against libcuda).
EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over `batch` matrices stored [outer, inner], boxes of
// box_inner x box_outer x 1 in the 128-byte swizzle; out of bounds reads 0.
int encode(CUtensorMap* map, const void* ptr, bool f32, int inner, int outer,
           int batch, int box_inner, int box_outer) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {dims[0] * es, dims[0] * dims[1] * es};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(
      map,
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device, once per device and kernel (`raised` holds one bit a device), so
// a launch costs no attribute call after the first.
template <typename Kernel>
int raise_smem_limit(Kernel kernel, int bytes, std::atomic<uint64_t>& raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit && (raised.load(std::memory_order_relaxed) & bit)) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  raised.fetch_or(bit, std::memory_order_relaxed);
  return 0;
}

template <bool A_F32, bool B_F32, bool A_MN, bool B_K>
int launch_tma(const Args& x) {
  using C = TmaCfg<A_F32, B_F32>;
  CUtensorMap ma{}, mb{}, mo{};
  int err = 0;
  if (!A_F32)
    err = encode(&ma, x.a, false, A_MN ? x.n : x.m, A_MN ? x.m : x.n, x.batch,
                 64, 64);
  if (!err && !B_F32)
    err = encode(&mb, x.b, false, B_K ? x.m : x.f, B_K ? x.f : x.m, x.batch,
                 64, 64);
  if (!err) err = encode(&mo, x.out, true, x.f, x.n, x.batch, 32, 64);
  if (err) return err;
  auto kernel = bmm_tma_kernel<A_F32, B_F32, A_MN, B_K>;
  static std::atomic<uint64_t> raised{0};
  err = raise_smem_limit(kernel, C::kSmem, raised);
  if (err) return err;
  const dim3 grid((x.f + kTileN - 1) / kTileN, (x.n + 63) / 64, x.batch);
  kernel<<<grid, C::kThreads, C::kSmem, x.stream>>>(
      ma, mb, mo, static_cast<const float*>(x.a),
      static_cast<const float*>(x.b), x.n, x.m, x.f);
  return 0;
}

template <bool A_MN, bool B_K>
int tma_dtypes(const Args& x, int a_dtype, int b_dtype) {
  if (a_dtype == 1 && b_dtype == 1)
    return launch_tma<false, false, A_MN, B_K>(x);
  if (a_dtype == 1 && b_dtype == 0)
    return launch_tma<false, true, A_MN, B_K>(x);
  if (a_dtype == 0 && b_dtype == 1)
    return launch_tma<true, false, A_MN, B_K>(x);
  if (a_dtype == 0 && b_dtype == 0)
    return launch_tma<true, true, A_MN, B_K>(x);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_tma(const Args& x, int a_dtype, int b_dtype, int trans_a,
                 int trans_b) {
  if (!trans_a && !trans_b)
    return tma_dtypes<false, false>(x, a_dtype, b_dtype);
  if (trans_a && !trans_b) return tma_dtypes<true, false>(x, a_dtype, b_dtype);
  if (!trans_a && trans_b) return tma_dtypes<false, true>(x, a_dtype, b_dtype);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The "tma" route's requirements (the caller's route rule, checked again):
// 16-byte aligned bases, rows of a multiple of 16 bytes, f % 4 == 0.
bool tma_aligned(const Args& x, int a_dtype, int b_dtype, int trans_a,
                 int trans_b) {
  const int a_inner = trans_a ? x.n : x.m, b_inner = trans_b ? x.m : x.f;
  auto ok = [](const void* p, int inner, int dtype) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
           inner % (dtype == 1 ? 8 : 4) == 0;
  };
  return ok(x.a, a_inner, a_dtype) && ok(x.b, b_inner, b_dtype) &&
         ok(x.out, x.f, 0);
}

}  // namespace

extern "C" {

// a_dtype, b_dtype: 0 = float32, 1 = bfloat16.  route: 0 = generic,
// 1 = tma.
// Shapes as above; all tensors contiguous, batch <= 65535.  Returns the
// first CUDA error (0 = cudaSuccess).
int tgp_bmm(const void* a, const void* b, void* out, int batch, int n, int m,
            int f, int a_dtype, int b_dtype, int trans_a, int trans_b,
            int route, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0 || f <= 0 || batch > 65535 ||
      a_dtype < 0 || a_dtype > 1 || b_dtype < 0 || b_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args x{a, b, static_cast<float*>(out), batch, n, m, f,
               static_cast<cudaStream_t>(stream)};
  int err;
  if (route == 0) {
    err = dispatch_generic(x, a_dtype, b_dtype, trans_a, trans_b);
  } else if (route == 1) {
    if (!tma_aligned(x, a_dtype, b_dtype, trans_a, trans_b))
      return static_cast<int>(cudaErrorMisalignedAddress);
    err = dispatch_tma(x, a_dtype, b_dtype, trans_a, trans_b);
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
