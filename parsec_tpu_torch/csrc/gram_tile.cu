// Split-K Gram kernel: G = X^T X in true f32, for Hopper (sm_90a).
//
// The Gram products of the inner-blocked QR panel
// (parsec_tpu_torch/apps/qr.py::_cholqr2: two per ib-wide column block of
// every GEQRT).  It replaces the blocked Pallas kernel of the JAX package
// (parsec_tpu/apps/pallas_kernels.py::pallas_gram_tile over _blocked_gram,
// the pl.pallas_call at :169).
//
//   X (M, N): f32, row-major, contiguous.   G (N, N): f32, written whole.
//   P: f32 scratch of splits x T x 64 x 64 (T upper tiles), made by the
//   wrapper and checked against its stated length.  Any M, N: the ragged
//   edge is masked inside the kernel (M = 0 gives G = 0), so there is no
//   unaligned-shape fallback.
//
// Precision: plain f32 FMA, never TF32.  G feeds a Cholesky whose error
// grows as cond(X)^2, and the JAX package runs this product at HIGHEST
// for that reason (a DEFAULT-precision panel gave a factorization residual
// of 1.19, BENCH.md).
//
// Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores, 3.35
// TB/s): the least work is M*N*(N+1) flop (the upper triangle only); at
// the QR path's X of 6144 x 512 that is 1.61e9 flop, 0.024 ms, against
// 13.6 MB of traffic (X read once, G written once), 0.004 ms — bound by
// operations.
//
// Design.  X is tall and narrow, so G has few tiles (36 upper 64 x 64 tiles
// at N = 512): the rows of X are split among blocks instead.
//   * Pass 1 (gram_partial_kernel): one block of 64 threads for each upper
//     64 x 64 tile of G and each run of rows_per_split rows of X (the split
//     plan is computed by the wrapper, apps/cuda_kernels.py::
//     gram_split_plan, for kBlocksPerSM blocks per SM; kT, kKC and
//     kBlocksPerSM have copies there, GRAM_*, that a CPU test holds equal
//     to these).  Each thread keeps 8 x 8
//     outputs in registers and does 64 FMAs for every four 16-byte shared
//     loads; the two 16-row operand panels are filled by a double-buffered
//     cp.async ring (one panel on a diagonal tile), zero-filled past the
//     edge.  The block writes its partial tile to P.
//   * Pass 2 (gram_reduce_kernel): for each upper tile, the partials are
//     summed in split order, a fixed order with no atomics, so two calls
//     give bit-identical G; the tile is written, and off the diagonal its
//     mirror too, through shared memory so both writes are row-contiguous.
//     A diagonal tile is symmetric bit for bit (x*y and y*x summed in one
//     order), so G equals its transpose exactly.
// The kernels allocate nothing and do not synchronise the device.
//
// What the design leaves: the FMA pipes, not the tensor cores, do the work
// (a 3xTF32 split on wgmma would move it there within f32 accuracy), the
// diagonal tiles compute their lower half, and the partials make a round
// trip through L2 (splits x T x 16 KB).
//
// C interface (bound with ctypes): launches both passes on `stream` of
// `device` and returns a cudaError_t as an int (0 = launched).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kT = 64;        // output tile of G (rows and cols)
constexpr int kKC = 16;       // rows of X per pipeline stage
constexpr int kThreads = 64;  // 8 x 8 threads of 8 x 8 outputs
constexpr int kBlocksPerSM = 6;  // registers capped so that 6 fit an SM;
                                 // the split plan aims at as many
constexpr int kSlab = 16;     // rows of a tile per reduce block
constexpr int kRThreads = kSlab * kT / 4;  // one float4 of a slab a thread

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  // src_bytes 0 zero-fills the 16-byte destination
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// upper tile number (row-major over bi <= bj) -> (bi, bj)
__device__ __forceinline__ void upper_tile(int t, int nb, int& bi, int& bj) {
  bi = 0;
  while (t >= nb - bi) {
    t -= nb - bi;
    ++bi;
  }
  bj = bi + t;
}

// kVec: N % 4 == 0 and X 16-byte aligned, so a panel row travels in 16-byte
// pieces that lie wholly inside or outside the matrix; else 4-byte pieces
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    gram_partial_kernel(const float* __restrict__ X, float* __restrict__ P,
                        int M, int N, int rows_per_split) {
  const int nb = (N + kT - 1) / kT;
  int bi, bj;
  upper_tile(blockIdx.x, nb, bi, bj);
  const bool diag = bi == bj;
  const int i0 = bi * kT;
  const int j0 = bj * kT;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(M, r0 + rows_per_split);
  const int nch = r1 > r0 ? (r1 - r0 + kKC - 1) / kKC : 0;

  __shared__ __align__(16) float Xi[2][kKC][kT];  // X[k.., i0..i0+63]
  __shared__ __align__(16) float Xj[2][kKC][kT];  // X[k.., j0..j0+63]

  const int tid = threadIdx.x;
  const int tx = tid % 8;  // columns tx*4 .. +3 and 32 + tx*4 .. +3
  const int ty = tid / 8;  // rows ty*4 .. +3 and 32 + ty*4 .. +3

  auto load = [&](int buf, int ch) {
    const int k0 = r0 + ch * kKC;
    if (kVec) {
#pragma unroll
      for (int q = 0; q < kKC * kT / 4 / kThreads; ++q) {
        const int e = q * kThreads + tid;
        const int r = e / (kT / 4);
        const int c = (e % (kT / 4)) * 4;
        const int gr = k0 + r;
        const size_t row = static_cast<size_t>(gr) * N;
        const bool in_i = gr < r1 && i0 + c < N;
        cp_async16(&Xi[buf][r][c], in_i ? X + row + i0 + c : X,
                   in_i ? 16 : 0);
        if (!diag) {
          const bool in_j = gr < r1 && j0 + c < N;
          cp_async16(&Xj[buf][r][c], in_j ? X + row + j0 + c : X,
                     in_j ? 16 : 0);
        }
      }
    } else {
#pragma unroll 4
      for (int q = 0; q < kKC * kT / kThreads; ++q) {
        const int e = q * kThreads + tid;
        const int r = e / kT;
        const int c = e % kT;
        const int gr = k0 + r;
        const size_t row = static_cast<size_t>(gr) * N;
        const bool in_i = gr < r1 && i0 + c < N;
        cp_async4(&Xi[buf][r][c], in_i ? X + row + i0 + c : X, in_i ? 4 : 0);
        if (!diag) {
          const bool in_j = gr < r1 && j0 + c < N;
          cp_async4(&Xj[buf][r][c], in_j ? X + row + j0 + c : X,
                    in_j ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  if (nch > 0) load(0, 0);
  for (int ch = 0; ch < nch; ++ch) {
    const int cur = ch & 1;
    if (ch + 1 < nch) {
      // the other buffer was last read before the previous iteration's
      // closing barrier, so it may be refilled now
      load(cur ^ 1, ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float(*xi)[kT] = Xi[cur];
    const float(*xj)[kT] = diag ? Xi[cur] : Xj[cur];
#pragma unroll
    for (int k = 0; k < kKC; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xi[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xi[k][32 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&xj[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&xj[k][32 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

  float* out = P + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                       (kT * kT);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = (r < 4 ? 0 : 32) + ty * 4 + (r % 4);
    *reinterpret_cast<float4*>(out + row * kT + tx * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    *reinterpret_cast<float4*>(out + row * kT + 32 + tx * 4) =
        make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
}

// blockIdx.x: upper tile; blockIdx.y: slab of kSlab rows of it
__global__ void __launch_bounds__(kRThreads)
    gram_reduce_kernel(const float* __restrict__ P, float* __restrict__ G,
                       int N, int splits) {
  const int nb = (N + kT - 1) / kT;
  int bi, bj;
  upper_tile(blockIdx.x, nb, bi, bj);
  const int i0 = bi * kT;
  const int j0 = bj * kT;
  const int tid = threadIdx.x;
  const int lr = tid / (kT / 4);
  const int lc = (tid % (kT / 4)) * 4;
  const int row = blockIdx.y * kSlab + lr;

  const size_t step = static_cast<size_t>(gridDim.x) * kT * kT;
  const float* p = P + static_cast<size_t>(blockIdx.x) * kT * kT + row * kT +
                   lc;
  float4 s = *reinterpret_cast<const float4*>(p);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 v = *reinterpret_cast<const float4*>(p + sp * step);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const float sv[4] = {s.x, s.y, s.z, s.w};

  const int gi = i0 + row;
  if (gi < N) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j0 + lc + e < N) G[static_cast<size_t>(gi) * N + j0 + lc + e] = sv[e];
  }
  if (bi == bj) return;  // the whole block: a diagonal tile has no mirror

  __shared__ float tile[kSlab][kT + 1];
#pragma unroll
  for (int e = 0; e < 4; ++e) tile[lr][lc + e] = sv[e];
  __syncthreads();
  // the mirror G[j0 + c][i0 + slab row], kSlab contiguous floats a row
  for (int e = tid; e < kSlab * kT; e += kRThreads) {
    const int c = e / kSlab;
    const int r = e % kSlab;
    const int gj = j0 + c;
    const int gr = i0 + blockIdx.y * kSlab + r;
    if (gj < N && gr < N) G[static_cast<size_t>(gj) * N + gr] = tile[r][c];
  }
}

}  // namespace

// P holds p_floats floats; the call is refused unless they take the
// partials of the plan (splits x tiles x kT^2) and its runs cover X's rows
extern "C" int parsec_gram_tile_f32(const void* X, void* G, void* P,
                                    long long p_floats, int M, int N,
                                    int splits, int rows_per_split,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M < 0 || N <= 0 || splits <= 0 || splits > 65535 ||
      rows_per_split <= 0 ||
      static_cast<long long>(splits) * rows_per_split < M)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (N + kT - 1) / kT;
  const int tiles = nb * (nb + 1) / 2;
  if (static_cast<long long>(splits) * tiles * kT * kT > p_floats)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(X);
  float* p = static_cast<float*>(P);
  const dim3 grid(tiles, splits);
  if (N % 4 == 0 && (reinterpret_cast<uintptr_t>(X) & 15u) == 0)
    gram_partial_kernel<true><<<grid, kThreads, 0, s>>>(x, p, M, N,
                                                        rows_per_split);
  else
    gram_partial_kernel<false><<<grid, kThreads, 0, s>>>(x, p, M, N,
                                                         rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_reduce_kernel<<<dim3(tiles, kT / kSlab), kRThreads, 0, s>>>(
      p, static_cast<float*>(G), N, splits);
  return static_cast<int>(cudaGetLastError());
}
