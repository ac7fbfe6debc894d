// Triangular tile product for the Cholesky TRSM: O = A @ tril(W)^T, for
// Hopper (sm_90a).
//
// The TRSM body of the tiled Cholesky (parsec_tpu_torch/apps/potrf.py:
// A[m,k] <- A[m,k] @ W[k]^T with W = L[k,k]^-1 from POTRF's tri_inv, whose
// strict upper triangle is exactly zero).  It replaces no Pallas kernel:
// the JAX package leaves this mixed bf16 x f32 product to XLA outside any
// kernel (parsec_tpu/apps/potrf.py's _k_trsm).  It was added because the
// library's full f32 product multiplies by W's structural zeros: half its
// work, in a product that held 56% of the tiled Cholesky's device time at
// 6144 tiles on an H100.
//
//   A (M, K): bf16 or f32, row-major, contiguous (the panel tile C).
//   W (N, K), N == K: f32, row-major, contiguous.  Only its lower triangle
//   is read; the entries above the diagonal are taken as zero.
//   O (M, N): A's type, row-major, contiguous; must not overlap A or W.
//   Any M, N: the ragged edge is masked inside the kernel.
//
// Arithmetic: plain fmaf in f32 on the FP32 pipes, never TF32 nor tensor
// cores; bf16 elements of A widen to f32 exactly; each output sums its k
// range in one fixed order and is rounded once to O's type (to nearest
// even for bf16), so two calls are bit-identical.  A product by one of
// W's zeros adds nothing to an f32 sum, so leaving it out changes no bit
// of the exact products' sum: the contract of BLAS strmm with uplo 'L'.
//
// Bound on an H100 SXM (67 TFLOP/s f32 FMA, 3.35 TB/s): the useful work is
// the lower triangle, ~M*N*K flop (2 * M * sum_n (n + 1)); at the potrf
// cell's 6144^3 that is 2.32e11 flop, 3.46 ms, against 0.07 ms of traffic
// (A read and O written in bf16, W read in f32 once).  The kernel computes
// 2 * M * 128^2 * sum_j j flop over whole 128-column blocks, 2.37e11 at
// 6144 (51% of the full product): 3.53 ms at the FMA peak.
//
// Design: K1's fma route (gemm_tile.cu's gemm_tile_f32_kernel, the SIMT
// GEMM of the FP32 pipes) with W as its transposed B, cut to the triangle:
//   * 128 x 128 output blocks of 128 threads, 16 x 8 outputs a thread as
//     4 x 2 sub-tiles of 4 x 4 (rows 32 apart, columns 64 apart): 6 float4
//     fragment loads from shared memory per 128 FMAs; two blocks an SM.
//   * Slabs 16 deep in a ring of 3 stages in dynamic shared memory (49.5
//     KB a block), k-major with rows 528 bytes apart; one barrier a slab.
//     While slab k is computed, slab k + 1 (fetched an iteration earlier)
//     is stored into the next stage and slab k + 2 is fetched into
//     registers.
//   * Triangle skip: output column block n0 stops its k loop at
//     min(K, n0 + 128), so W's rows past n0 + 127 never meet a k-slab
//     beyond them; inside the diagonal block, W's entries above the
//     diagonal are loaded as zeros and never read from memory.
//   * Heaviest blocks first: a one-dimensional grid walks the column
//     blocks from the right (most slabs) to the left, the row blocks of
//     one column block in a row, so the short blocks fill the last wave
//     (the work per block varies 48:1 at 6144) and blocks in flight share
//     W's slabs in L2.
//   * A in its own type: bf16 A is fetched as 16-byte loads of 8 elements
//     and widened to f32 as it is stored into its stage; O is written in
//     bf16 with one rounding.  The wrapper allocates O and nothing else.
//   * Bank conflicts: a warp's transposed stores of a slab hit 32 distinct
//     banks.  W's and f32 A's fetch (8 rows by 4 k-quads a warp) swaps the
//     upper 8 k-rows' 8-column groups in pairs; bf16 A's fetch (16 rows by
//     2 k-octets a warp) swaps 16-column groups instead.  Float4 fragments
//     stay whole under both.
//   * Vector and scalar variants of one kernel, picked on the host: the
//     vector one needs K % 4 == 0 (K % 8 == 0 for bf16 A) and 16-byte
//     aligned A, W and O; any other call loads and stores element by
//     element, masked, through the same tiles and ring.
//
// Helpers shared in kind with gemm_tile.cu (the float4 fetch, the k-major
// stash, the swizzle) are carried here as their own copies, so that K1's
// source stays as it is.
//
// What the design leaves: the diagonal block still multiplies the zeros
// of its own 128 x 128 triangle (2% of the work at 6144); no split-K or
// stream-K for calls with fewer blocks than the card has slots; the FMA
// pipes, not the tensor cores, do the work (the f32 product is the
// reference's arithmetic).
//
// C interface (bound with ctypes): launches on `stream` of `device` and
// returns a cudaError_t as an int (0 = launched); N != K is
// cudaErrorInvalidValue, and nothing is launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kB = 128;          // block tile (rows and cols)
constexpr int kK = 16;           // K per slab
constexpr int kTM = 16;          // outputs a thread: 16 rows by 8 columns,
constexpr int kTN = 8;           // as 4 x 2 sub-tiles of 4 x 4
constexpr int kRowStep = kB / (kTM / 4);   // sub-tile rows 32 apart
constexpr int kColStep = kB / (kTN / 4);   // sub-tile columns 64 apart
constexpr int kThreads = (kB / kTM) * (kB / kTN);   // 8 x 16 = 128
constexpr int kBlocksPerSM = 2;
constexpr int kStages = 3;
// 16-byte loads a thread makes of an f32 slab (4) and of a bf16 slab (2)
constexpr int kLoads32 = kB * kK / 4 / kThreads;
constexpr int kLoads16 = kB * kK / 8 / kThreads;
// shared row pitch of the k-major slabs (528 bytes)
constexpr int kLd = kB + 4;
constexpr int kStage = 2 * kK * kLd;       // floats: A's slab, then W's
constexpr int kSmem = kStages * kStage * 4;   // 50688 bytes, dynamic
constexpr int kMaxDevices = 64;

// where column c of k-row k of a slab lies: the upper 8 k-rows have their
// column groups of `G` swapped in pairs (G = 8 for 8 rows by 4 k-quads a
// warp, 16 for 16 rows by 2 k-octets), so that k-rows k and k + 8, whose
// pitch puts them on the same banks, take different ones
template <int G>
__device__ __forceinline__ int swz(int k, int c) {
  return c ^ ((k & 8) ? G : 0);
}

// four consecutive f32 elements of row `row` of a row-major (R, Cn) matrix
// from column `col`, zero past the edge and past column `last` (the
// triangle: elements with col + j > last are zeros, never read): one
// float4 load where all four lie inside (Vec: Cn % 4 == 0 on a 16-byte
// aligned base), else masked scalar loads
template <bool Vec>
__device__ __forceinline__ float4 fetch4(const float* __restrict__ X, int R,
                                         int Cn, int row, int col, int last) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row >= R) return v;
  const float* p = X + static_cast<size_t>(row) * Cn + col;
  const int end = min(Cn - 1, last);   // the last column that is read
  if (Vec && col + 3 <= end) {
    v = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    if (col <= end) v.x = __ldg(p);
    if (col + 1 <= end) v.y = __ldg(p + 1);
    if (col + 2 <= end) v.z = __ldg(p + 2);
    if (col + 3 <= end) v.w = __ldg(p + 3);
  }
  return v;
}

// eight consecutive bf16 elements of row `row` of a row-major (R, Cn)
// matrix from column `col` as raw bits, zero past the edge: one 16-byte
// load (Vec: Cn % 8 == 0 on a 16-byte aligned base), or eight masked
// 2-byte loads
template <bool Vec>
__device__ __forceinline__ uint4 fetch8(const bf16* __restrict__ X, int R,
                                        int Cn, int row, int col) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= R) return v;
  const bf16* p = X + static_cast<size_t>(row) * Cn + col;
  if constexpr (Vec) {
    if (col < Cn) v = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    uint32_t h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      h[j] = col + j < Cn ? static_cast<uint32_t>(__ldg(q + j)) : 0u;
    v = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                   h[4] | (h[5] << 16), h[6] | (h[7] << 16));
  }
  return v;
}

// k-quad c of row r of an (R, K) f32 operand into its k-major slab S
template <int G>
__device__ __forceinline__ void stash4(float* S, float4 v, int r, int c) {
  S[c * kLd + swz<G>(c, r)] = v.x;
  S[(c + 1) * kLd + swz<G>(c + 1, r)] = v.y;
  S[(c + 2) * kLd + swz<G>(c + 2, r)] = v.z;
  S[(c + 3) * kLd + swz<G>(c + 3, r)] = v.w;
}

// k-octet c of row r of an (R, K) bf16 operand, widened to f32 (exact: a
// bf16 is the upper half of its f32), into its k-major slab S
__device__ __forceinline__ void stash8(float* S, uint4 v, int r, int c) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    S[(c + 2 * j) * kLd + swz<16>(c + 2 * j, r)] = __uint_as_float(w[j] << 16);
    S[(c + 2 * j + 1) * kLd + swz<16>(c + 2 * j + 1, r)] =
        __uint_as_float(w[j] & 0xffff0000u);
  }
}

// Block b computes O's 128 x 128 tile at (128 rb, 128 cb), with cb walking
// the column blocks from the right: the heaviest blocks start first.
// Thread (ty, tx) owns rows 32 s + 4 ty + {0..3} (s < 4) and columns
// 64 h + 4 tx + {0..3} (h < 2).  The k loop runs over [0, min(K, n0 +
// 128)); W's rows n0.. of a slab read only k <= n.  TA is A's and O's
// type; Vec is the vector variant, chosen on the host.
template <typename TA, bool Vec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    trsm_tile_f32_kernel(const TA* __restrict__ A,
                         const float* __restrict__ W, TA* __restrict__ O,
                         int M, int N, int K) {
  constexpr bool kBf16 = std::is_same<TA, bf16>::value;
  constexpr int kG = kBf16 ? 16 : 8;      // A's swizzle group
  constexpr int kLoadsA = kBf16 ? kLoads16 : kLoads32;
  using PA = typename std::conditional<kBf16, uint4, float4>::type;
  extern __shared__ __align__(16) float tsmem[];
  const int tid = threadIdx.x;
  const int nbm = (M + kB - 1) / kB;
  const int nbn = (N + kB - 1) / kB;
  const int m0 = (blockIdx.x % nbm) * kB;
  const int n0 = (nbn - 1 - static_cast<int>(blockIdx.x) / nbm) * kB;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8;
  const int tx = (warp % 2) * 8 + lane % 8;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  // load e = tid + p kThreads of a slab: f32 rows e / 4, k-quad e % 4;
  // bf16 rows e / 2, k-octet e % 2
  PA pa[kLoadsA];
  float4 pw[kLoads32];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int p = 0; p < kLoadsA; ++p) {
      const int e = tid + p * kThreads;
      if constexpr (kBf16)
        pa[p] = fetch8<Vec>(A, M, K, m0 + e / 2, k0 + (e % 2) * 8);
      else
        pa[p] = fetch4<Vec>(A, M, K, m0 + e / 4, k0 + (e % 4) * 4, K);
    }
#pragma unroll
    for (int p = 0; p < kLoads32; ++p) {
      const int e = tid + p * kThreads;
      const int n = n0 + e / 4;
      // row n of W: columns k <= n only (the lower triangle)
      pw[p] = fetch4<Vec>(W, N, K, n, k0 + (e % 4) * 4, n);
    }
  };
  auto stash = [&](int st) {
    float* As = tsmem + st * kStage;
    float* Ws = As + kK * kLd;
#pragma unroll
    for (int p = 0; p < kLoadsA; ++p) {
      const int e = tid + p * kThreads;
      if constexpr (kBf16)
        stash8(As, pa[p], e / 2, (e % 2) * 8);
      else
        stash4<8>(As, pa[p], e / 4, (e % 4) * 4);
    }
#pragma unroll
    for (int p = 0; p < kLoads32; ++p) {
      const int e = tid + p * kThreads;
      stash4<8>(Ws, pw[p], e / 4, (e % 4) * 4);
    }
  };
  auto compute = [&](int st) {
    const float* As = tsmem + st * kStage;
    const float* Ws = As + kK * kLd;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int s = 0; s < kTM / 4; ++s) {
        const float4 v = *reinterpret_cast<const float4*>(
            As + kk * kLd + swz<kG>(kk, s * kRowStep + 4 * ty));
        a[4 * s] = v.x;
        a[4 * s + 1] = v.y;
        a[4 * s + 2] = v.z;
        a[4 * s + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < kTN / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            Ws + kk * kLd + swz<8>(kk, h * kColStep + 4 * tx));
        b[4 * h] = v.x;
        b[4 * h + 1] = v.y;
        b[4 * h + 2] = v.z;
        b[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  };

  // the triangle: no k past this column block's last row of W
  const int kend = min(K, n0 + kB);
  const int nk = (kend + kK - 1) / kK;
  if (nk > 0) {
    fetch(0);
    stash(0);
  }
  if (nk > 1) fetch(kK);
  __syncthreads();
  int cur = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int next = cur == kStages - 1 ? 0 : cur + 1;
    // stage `next` was last read two iterations ago, before a barrier
    if (kt + 1 < nk) stash(next);
    if (kt + 2 < nk) fetch((kt + 2) * kK);
    compute(cur);
    __syncthreads();     // one barrier a slab
    cur = next;
  }

  // O = acc, rounded once to O's type
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + (i / 4) * kRowStep + 4 * ty + i % 4;
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < kTN / 4; ++h) {
      const int col = n0 + h * kColStep + 4 * tx;
      const size_t idx = static_cast<size_t>(row) * N + col;
      const float* v = &acc[i][4 * h];
      if constexpr (Vec) {
        if (col < N) {
          if constexpr (kBf16) {
            const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
            const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
            uint2 bits;
            bits.x = *reinterpret_cast<const uint32_t*>(&lo);
            bits.y = *reinterpret_cast<const uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(O + idx) = bits;
          } else {
            *reinterpret_cast<float4*>(O + idx) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) {
            if constexpr (kBf16)
              O[idx + j] = __float2bfloat16_rn(v[j]);
            else
              O[idx + j] = v[j];
          }
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// once per device and variant: lift the kernel's dynamic shared-memory
// limit above 48 KB; then one launch over the 128 x 128 tiles, heaviest
// column blocks first
template <typename TA, bool Vec>
int trsm_launch(const TA* A, const float* W, TA* O, int M, int N, int K,
                int device, cudaStream_t stream) {
  static std::once_flag once[kMaxDevices];
  static cudaError_t err[kMaxDevices];
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  std::call_once(once[device], [device] {
    err[device] = cudaFuncSetAttribute(
        trsm_tile_f32_kernel<TA, Vec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  });
  if (err[device] != cudaSuccess) return static_cast<int>(err[device]);
  const unsigned blocks = static_cast<unsigned>((M + kB - 1) / kB) *
                          static_cast<unsigned>((N + kB - 1) / kB);
  trsm_tile_f32_kernel<TA, Vec><<<blocks, kThreads, kSmem, stream>>>(
      A, W, O, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// O (M, N) = A (M, K) @ tril(W (N, K))^T with N == K; a_bf16 = 1 for bf16 A
// and O, 0 for f32.  The vector variant takes every call whose rows are
// whole 16-byte loads on 16-byte aligned bases; any other call runs the
// scalar variant of the same kernel.
extern "C" int parsec_trsm_tile(const void* A, const void* W, void* O, int M,
                                int N, int K, int a_bf16, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N != K) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(W);
  const bool vec = K % (a_bf16 ? 8 : 4) == 0 && aligned16(A) &&
                   aligned16(W) && aligned16(O);
  if (a_bf16) {
    const bf16* a = static_cast<const bf16*>(A);
    bf16* o = static_cast<bf16*>(O);
    return vec ? trsm_launch<bf16, true>(a, w, o, M, N, K, device, s)
               : trsm_launch<bf16, false>(a, w, o, M, N, K, device, s);
  }
  const float* a = static_cast<const float*>(A);
  float* o = static_cast<float*>(O);
  return vec ? trsm_launch<float, true>(a, w, o, M, N, K, device, s)
             : trsm_launch<float, false>(a, w, o, M, N, K, device, s);
}
