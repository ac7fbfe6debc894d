// Blocked Gram kernel: G = X^T X in true f32, for Hopper (sm_90a).
//
// The Gram products of the inner-blocked QR panel
// (parsec_tpu_torch/apps/qr.py::_cholqr2: two per ib-wide column block of
// every GEQRT).  It replaces the blocked Pallas kernel of the JAX package
// (parsec_tpu/apps/pallas_kernels.py::pallas_gram_tile over _blocked_gram,
// the pl.pallas_call at :169).
//
//   X (M, N): f32, row-major, contiguous.   G (N, N): f32, written whole.
//   Any M, N: the ragged edge is masked inside the kernel (M = 0 gives
//   G = 0), so there is no unaligned-shape fallback.
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
// Design.  One block per 32 x 32 tile of G, upper tiles only (bi <= bj);
// each block writes its tile and, off the diagonal, the mirrored tile, so
// the symmetric half is never computed.  The K loop runs over the rows of
// X inside the block (the TPU program's sequential K grid axis and its
// scratch accumulator have no counterpart: CUDA blocks run in no order, so
// nothing carries across blocks).  The few output tiles of a narrow X
// (136 at N = 512) would leave each SM two warps, so a block splits its
// rows among four k-groups of 64 threads (4 x 4 outputs a thread, operands
// from two shared-memory panels of 32 rows, the next panel prefetched
// into registers while the current one is multiplied) and sums the four
// partial tiles through shared memory in a fixed order at the end.  The
// kernel allocates nothing and does not synchronise the device.
//
// What the simple design leaves: the FMA pipes, not tensor cores, do the
// work (a 3xTF32 split on wgmma would move it to the tensor cores within
// f32 accuracy), and 136 tiles on 132 SMs leave four SMs with two blocks.
//
// C interface (bound with ctypes): launches on `stream` of `device` and
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kT = 32;                  // output tile of G (rows and cols)
constexpr int kKC = 32;                 // rows of X per shared panel
constexpr int kGroups = 4;              // k-groups of a block
constexpr int kThreads = 64 * kGroups;  // 64 threads a group: 8 x 8 of 4 x 4
constexpr int kLoads = kKC * kT / kThreads;  // panel elements a thread loads

__global__ void __launch_bounds__(kThreads)
    gram_tile_f32_kernel(const float* __restrict__ X, float* __restrict__ G,
                         int M, int N) {
  const int bi = blockIdx.y;
  const int bj = blockIdx.x;
  if (bi > bj) return;  // lower tiles are written as mirrors of upper ones
  const int i0 = bi * kT;
  const int j0 = bj * kT;

  __shared__ __align__(16) float Xi[kKC][kT];  // X[k0.., i0..i0+31]
  __shared__ __align__(16) float Xj[kKC][kT];  // X[k0.., j0..j0+31]
  __shared__ float red[kGroups][kT][kT + 1];   // partial tiles

  const int tid = threadIdx.x;
  const int grp = tid / 64;
  const int ty = (tid % 64) / 8;  // output rows ty*4 .. ty*4+3
  const int tx = tid % 8;         // output cols tx*4 .. tx*4+3

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  // element e = q * kThreads + tid of a panel: row e / kT, column e % kT,
  // so neighbouring threads read neighbouring addresses of one row of X
  float pi[kLoads], pj[kLoads];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int e = q * kThreads + tid;
      const int gr = k0 + e / kT;
      const int c = e % kT;
      const bool row_in = gr < M;
      const size_t base = static_cast<size_t>(gr) * N;
      pi[q] = (row_in && i0 + c < N) ? X[base + i0 + c] : 0.0f;
      pj[q] = (row_in && j0 + c < N) ? X[base + j0 + c] : 0.0f;
    }
  };

  const int nchunks = (M + kKC - 1) / kKC;
  if (nchunks > 0) fetch(0);
  for (int ch = 0; ch < nchunks; ++ch) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int e = q * kThreads + tid;
      Xi[e / kT][e % kT] = pi[q];
      Xj[e / kT][e % kT] = pj[q];
    }
    __syncthreads();
    if (ch + 1 < nchunks) fetch((ch + 1) * kKC);  // in flight during the FMAs
#pragma unroll
    for (int t = 0; t < kKC / kGroups; ++t) {
      const int kk = t * kGroups + grp;
      const float4 a = *reinterpret_cast<const float4*>(&Xi[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Xj[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[grp][ty * 4 + r][tx * 4 + c] = acc[r][c];
  __syncthreads();

  // G[i][j] for the tile, neighbouring threads on neighbouring columns
  for (int e = tid; e < kT * kT; e += kThreads) {
    const int li = e / kT;
    const int lj = e % kT;
    if (i0 + li < N && j0 + lj < N) {
      const float s =
          ((red[0][li][lj] + red[1][li][lj]) + red[2][li][lj]) + red[3][li][lj];
      G[static_cast<size_t>(i0 + li) * N + j0 + lj] = s;
    }
  }
  if (bi == bj) return;
  // the mirrored tile G[j][i], again neighbouring threads on neighbouring
  // columns of G (the padded rows of `red` keep the column reads apart)
  for (int e = tid; e < kT * kT; e += kThreads) {
    const int lj = e / kT;
    const int li = e % kT;
    if (i0 + li < N && j0 + lj < N) {
      const float s =
          ((red[0][li][lj] + red[1][li][lj]) + red[2][li][lj]) + red[3][li][lj];
      G[static_cast<size_t>(j0 + lj) * N + i0 + li] = s;
    }
  }
}

}  // namespace

extern "C" int parsec_gram_tile_f32(const void* X, void* G, int M, int N,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M < 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (N + kT - 1) / kT;
  const dim3 grid(nb, nb);
  gram_tile_f32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<float*>(G), M, N);
  return static_cast<int>(cudaGetLastError());
}
