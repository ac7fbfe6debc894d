// GEMM-accumulate tile kernel: O = C + alpha * A @ B, for Hopper (sm_90a).
//
// The tile body of the tiled-GEMM task graph (parsec_tpu_torch/apps/gemm.py)
// and of the QR updates (apps/qr.py: UNMQR, TSMQR).  It replaces the blocked
// Pallas kernel of the JAX package (parsec_tpu/apps/pallas_kernels.py::
// pallas_gemm_tile over _blocked_matmul).
//
//   A (M, K), B (K, N): both bf16 or both f32, row-major, contiguous.
//   C, O (M, N): f32, row-major, contiguous; O does not alias C.
//   Any M, N, K: the ragged edge is masked inside the kernels.
//
// Three routes, chosen by the wrapper (apps/cuda_kernels.py::gemm_route)
// from the types, the shape and the pointers before launch:
//
// wgmma (bf16, every shape TMA can describe: K % 8 == 0, N % 8 == 0, K > 0,
// A and B 16-byte aligned, C 8-byte aligned) — every call on the paths.
//   * Persistent blocks, at most one per SM, in clusters of two on
//     neighbouring SMs, walk the 256 x 256 cluster tiles in a grouped
//     raster: 8 cluster tile rows at a time, so that the clusters in flight
//     share A and B slabs in L2.  Block r of a cluster takes rows 128 r..
//     of its cluster's tile; the B slab the two share is loaded once, each
//     block multicasting half of its boxes into both, which cuts the
//     L2-to-SM traffic of a stage by a third.
//   * Warp specialisation: warpgroups 0 and 1 consume, warpgroup 2
//     produces.  One producer thread keeps a ring of 4 stages full with TMA
//     loads (A: one 64 x 128 box; B: four boxes of 64 x 64), 128-byte
//     swizzled, each stage guarded by a full and an empty mbarrier (the
//     empty one counts the consumers of both blocks of the cluster, since
//     a multicast refills the stage in both).  The producer gives
//     registers up (setmaxnreg 40), the consumers take them (232): a
//     consumer holds its 64 x 256 f32 accumulator in registers.
//   * Each consumer warpgroup runs wgmma.mma_async m64n256k16 on its 64 rows:
//     A K-major, B MN-major (the transpose-B flag: B stays row-major as the
//     caller gives it).  One k-block's products stay in flight while the
//     next stage is awaited; a stage goes back to the producer as soon as
//     the products that read it are done.
//   * TMA zero-fills boxes that reach past M, N or K, so the main loop has
//     no edge branches; the epilogue writes O = C + alpha * acc straight
//     from the accumulator registers, eight column blocks at a time (all
//     their float2 loads of C in flight before the first float2 store of
//     O), rows and columns past the edge masked.
//   * The TMA descriptors are built on the host at every call (the
//     pointers change), through cuTensorMapEncodeTiled obtained with
//     cudaGetDriverEntryPoint, so the library needs no -lcuda; they reach
//     the kernel as __grid_constant__ parameters.
//
// wmma (bf16, the shapes TMA cannot describe): WMMA m16n16k16 with f32
// accumulators from padded, double-buffered shared tiles filled element by
// element with the edge masked.
//
// fma (f32): plain f32 FMA, never TF32, to keep the reference's f32
// semantics.
//
// The K loop runs inside a block in every route: it takes the place of the
// TPU program's sequential K grid axis and its scratch accumulator, since
// CUDA blocks run in no order.  No kernel allocates or synchronises.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 2*M*N*K flop
// against A and B read once in bf16, C read and O written in f32; at the
// paths' 2048^3, 6144^3 and 12288^3 tiles it is the operations (12288^3:
// 3.75 ms against 0.54 ms of traffic).
//
// What the design leaves: A is not multicast (a 2 x 2 cluster sharing it
// too was slower), one tile's epilogue does not overlap the same
// warpgroup's next main loop (the producer runs ahead, the tensor cores
// wait), and the epilogue writes O from registers rather than through
// shared memory and a TMA store.  The QR updates still hand the kernel a
// zero C and a transposed copy of V (apps/qr.py), which a beta = 0
// epilogue and wgmma's transpose-A would spare.
//
// C interface (bound with ctypes): each entry launches on `stream` of
// `device` and returns a cudaError_t as an int (0 = launched).

#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

// ---------------------------------------------------------------------------
// bf16 x bf16 -> f32 on wgmma, operands by TMA
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;        // block tile rows: two consumer warpgroups
constexpr int kWgBN = 256;        // block tile columns: one m64n256k16 wide
constexpr int kWgBK = 64;         // K per stage: one 128-byte swizzle row
constexpr int kWgCluster = 2;     // blocks of a cluster, sharing each B slab
constexpr int kWgGroupM = 8;      // cluster tile rows the raster walks together
constexpr int kWgStages = 4;
constexpr int kWgThreads = 384;   // warpgroups 0-1 consume, 2 produces
constexpr int kEpiBatch = 8;      // epilogue column blocks per batch
constexpr int kWgABytes = kWgBM * kWgBK * 2;   // 16 KB a stage
constexpr int kWgBBytes = kWgBK * kWgBN * 2;   // 32 KB a stage
constexpr int kWgBoxBytes = kWgBK * 64 * 2;    // one 64 x 64 B box
// stages, 1 KB to align them to the swizzle atom, full + empty barriers
constexpr int kWgSmem =
    kWgStages * (kWgABytes + kWgBBytes) + 1024 + 2 * kWgStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// returns once the phase of `bar` with the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// arrive on the barrier at the same shared offset in block `cta` of the
// cluster (this block's own rank included)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// one TMA box of a 2-D tensor map at coordinates (c0 innermost, c1) into
// shared memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the same box into the same shared offset of every block of the cluster in
// `mask`, each block's `bar` counting the bytes that land there
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst,
                                                      const CUtensorMap* map,
                                                      uint32_t bar, int c0,
                                                      int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "h"(mask)
      : "memory");
}

// wgmma shared-memory matrix descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (all in 16-byte units)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32, registers) += A (64 x 16, K-major) @ B (16 x N, MN-major,
// the transpose-B flag); scale_d == 0 overwrites D instead
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// output tile number -> (tile row, tile column) in the grouped raster:
// kWgGroupM tile rows are walked column by column
__device__ __forceinline__ void tile_coords(int tile, int tiles_m,
                                            int tiles_n, int& pm, int& pn) {
  const int span = kWgGroupM * tiles_n;
  const int g = tile / span;
  const int first = g * kWgGroupM;
  const int rows = min(tiles_m - first, kWgGroupM);
  const int r = tile - g * span;
  pm = first + r % rows;
  pn = r / rows;
}

// the cluster walks (128 kWgCluster) x 256 tiles, block r of it takes rows
// 128 r.. of each, and the B slab the blocks share is loaded once for all
// of them: each block multicasts its share of the 64-column boxes into
// every block of the cluster
__global__ void __launch_bounds__(kWgThreads, 1)
    gemm_tile_wgmma_kernel(const __grid_constant__ CUtensorMap tmA,
                           const __grid_constant__ CUtensorMap tmB,
                           const float* __restrict__ C,
                           float* __restrict__ O, int M, int N, int K,
                           float alpha) {
  constexpr int S = kWgStages;
  constexpr int CL = kWgCluster;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1 KB: stages start on that grid
  // (the same offsets in every block, as multicast needs)
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sA = base;
  const uint32_t sB = sA + S * kWgABytes;
  const uint32_t full = sB + S * kWgBBytes;
  const uint32_t empty = full + S * 8;

  const int tiles_m = (M + kWgBM * CL - 1) / (kWgBM * CL);
  const int tiles_n = (N + kWgBN - 1) / kWgBN;
  const int tiles = tiles_m * tiles_n;
  const int nk = (K + kWgBK - 1) / kWgBK;
  const int wg = threadIdx.x / 128;
  const int rank = static_cast<int>(cluster_rank());
  const int cluster = blockIdx.x / CL;
  const int clusters = gridDim.x / CL;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);  // the producer's expect_tx
      // one arrival per consumer warpgroup of every block of the cluster:
      // a stage is refilled (in all of them) once all have read it
      mbar_init(empty + 8 * s, 2 * CL);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // no block signals a peer's barriers before they exist

  // one if-else for the whole kernel: the roles never reconverge, so
  // ptxas can honour setmaxnreg
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = cluster; tile < tiles; tile += clusters) {
        int pm, pn;
        tile_coords(tile, tiles_m, tiles_n, pm, pn);
        const int row = (pm * CL + rank) * kWgBM;  // past M: TMA zero-fills
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, kWgABytes + kWgBBytes);
          tma_load_2d(sA + stage * kWgABytes, &tmA, bar, kb * kWgBK, row);
#pragma unroll
          for (int c = 0; c < kWgBN / 64; ++c)
            if (c % CL == rank)
              tma_load_2d_multicast(sB + stage * kWgBBytes + c * kWgBoxBytes,
                                    &tmB, bar, pn * kWgBN + c * 64,
                                    kb * kWgBK, (1u << CL) - 1);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      // the peers' consumers still arrive on this block's empty barriers:
      // wait for every stage's last release before the block may exit
      for (int s = 0; s < S; ++s) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    // lane 0 of warp r < CL releases a stage to block r of the cluster
    const bool signals = lane == 0 && warp < CL;
    float acc[kWgBN / 2];
#pragma unroll
    for (int i = 0; i < kWgBN / 2; ++i) acc[i] = 0.0f;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = cluster; tile < tiles; tile += clusters) {
      int pm, pn;
      tile_coords(tile, tiles_m, tiles_n, pm, pn);
      int prev = 0;
      fence_regs(acc);
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(full + 8 * stage, phase);
        // A: this warpgroup's 64 rows of 128 bytes, 8-row groups 1 KB
        // apart, k16 steps 32 bytes along the swizzled row.  B: 64-column
        // boxes kWgBoxBytes apart (leading offset), 8-row groups of K 1 KB
        // apart (stride offset), k16 steps 16 rows = 2 KB.
        const uint32_t a = sA + stage * kWgABytes + wg * 64 * 128;
        const uint32_t b = sB + stage * kWgBBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk)
          wgmma_m64n256k16(acc, sw128_desc(a + kk * 32, 16, 1024),
                           sw128_desc(b + kk * 2048, kWgBoxBytes, 1024),
                           (kb | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-block's products are done
        if (kb > 0 && signals) mbar_arrive_cluster(empty + 8 * prev, warp);
        prev = stage;
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (signals) mbar_arrive_cluster(empty + 8 * prev, warp);

      // accumulator fragment: warp w holds rows 16w..16w+15; in each 8-wide
      // column block j, lane l holds (l/4, 2(l%4) + {0,1}) in acc[4j],
      // acc[4j+1] and the same columns 8 rows down in acc[4j+2], acc[4j+3]
      const int row0 =
          (pm * CL + rank) * kWgBM + wg * 64 + warp * 16 + lane / 4;
      const int col0 = pn * kWgBN + 2 * (lane % 4);
      // kEpiBatch column blocks at a time: all their loads of C are in
      // flight before the first store of O (C read-only, O streamed)
#pragma unroll
      for (int j0 = 0; j0 < kWgBN / 8; j0 += kEpiBatch) {
        float2 cv[kEpiBatch][2];
#pragma unroll
        for (int j = 0; j < kEpiBatch; ++j) {
          const int col = col0 + 8 * (j0 + j);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            // N % 8 == 0: both columns of a pair are inside or outside
            cv[j][h] = col < N && row < M
                           ? __ldg(reinterpret_cast<const float2*>(
                                 C + static_cast<size_t>(row) * N + col))
                           : make_float2(0.0f, 0.0f);
          }
        }
#pragma unroll
        for (int j = 0; j < kEpiBatch; ++j) {
          const int col = col0 + 8 * (j0 + j);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            if (col < N && row < M)
              __stcs(reinterpret_cast<float2*>(
                         O + static_cast<size_t>(row) * N + col),
                     make_float2(
                         fmaf(alpha, acc[4 * (j0 + j) + 2 * h], cv[j][h].x),
                         fmaf(alpha, acc[4 * (j0 + j) + 2 * h + 1],
                              cv[j][h].y)));
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 x bf16 -> f32 on WMMA, for the shapes TMA cannot describe
// ---------------------------------------------------------------------------

constexpr int kBM = 128;              // block tile rows
constexpr int kBN = 128;              // block tile cols
constexpr int kBK = 32;               // K step per pipeline stage
constexpr int kWM = 64;               // warp tile rows (warps: 2 along M)
constexpr int kWN = 32;               // warp tile cols (warps: 4 along N)
constexpr int kThreads = 256;         // 8 warps
constexpr int kALd = kBK + 8;         // padded smem row (bf16 elements)
constexpr int kBLd = kBN + 8;

// Fill one stage: the BM x BK slab of A and the BK x BN slab of B starting
// at k0, element by element with the edge masked to zero (the rows of these
// shapes need not be 16-byte aligned).
__device__ __forceinline__ void load_stage(bf16 (*As)[kALd], bf16 (*Bs)[kBLd],
                                           const bf16* __restrict__ A,
                                           const bf16* __restrict__ B, int M,
                                           int N, int K, int m0, int n0,
                                           int k0, int tid) {
  const bf16 zero = __float2bfloat16(0.0f);
#pragma unroll
  for (int i = 0; i < (kBM * kBK / 8) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / (kBK / 8);
    const int col = (c % (kBK / 8)) * 8;
    const int gr = m0 + r;
    const int gc = k0 + col;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      As[r][col + e] = (gr < M && gc + e < K)
                           ? A[static_cast<size_t>(gr) * K + gc + e]
                           : zero;
  }
#pragma unroll
  for (int i = 0; i < (kBK * kBN / 8) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / (kBN / 8);
    const int col = (c % (kBN / 8)) * 8;
    const int gr = k0 + r;
    const int gc = n0 + col;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      Bs[r][col + e] = (gr < K && gc + e < N)
                           ? B[static_cast<size_t>(gr) * N + gc + e]
                           : zero;
  }
}

__global__ void __launch_bounds__(kThreads)
    gemm_tile_bf16_kernel(const bf16* __restrict__ A,
                          const bf16* __restrict__ B,
                          const float* __restrict__ C, float* __restrict__ O,
                          int M, int N, int K, float alpha) {
  __shared__ __align__(128) bf16 As[2][kBM][kALd];
  __shared__ __align__(128) bf16 Bs[2][kBK][kBLd];
  __shared__ __align__(128) float Cs[kThreads / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / (kBN / kWN);  // 0..1
  const int wn = warp % (kBN / kWN);  // 0..3
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kWM / 16][kWN / 16];
#pragma unroll
  for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (K + kBK - 1) / kBK;
  if (nk > 0) load_stage(As[0], Bs[0], A, B, M, N, K, m0, n0, 0, tid);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk)
      // the other stage was last read before the previous iteration's
      // closing barrier, so it may be refilled now
      load_stage(As[cur ^ 1], Bs[cur ^ 1], A, B, M, N, K, m0, n0,
                 (kt + 1) * kBK, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          af[kWM / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          bfrag[kWN / 16];
#pragma unroll
      for (int i = 0; i < kWM / 16; ++i)
        wmma::load_matrix_sync(af[i], &As[cur][wm * kWM + i * 16][kk], kALd);
#pragma unroll
      for (int j = 0; j < kWN / 16; ++j)
        wmma::load_matrix_sync(bfrag[j], &Bs[cur][kk][wn * kWN + j * 16],
                               kBLd);
#pragma unroll
      for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
        for (int j = 0; j < kWN / 16; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfrag[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 accumulator at a time through its
  // own shared scratch, then writes O = C + alpha * acc with the edge masked
  float* scratch = Cs[warp];
#pragma unroll
  for (int i = 0; i < kWM / 16; ++i) {
#pragma unroll
    for (int j = 0; j < kWN / 16; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int rb = m0 + wm * kWM + i * 16;
      const int cb = n0 + wn * kWN + j * 16;
      for (int e = lane; e < 16 * 16; e += 32) {
        const int gr = rb + e / 16;
        const int gc = cb + e % 16;
        if (gr < M && gc < N) {
          const size_t idx = static_cast<size_t>(gr) * N + gc;
          O[idx] = fmaf(alpha, scratch[e], C[idx]);
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// f32 x f32 -> f32 on plain FMA (no TF32)
// ---------------------------------------------------------------------------

constexpr int kFB = 64;   // block tile (rows and cols)
constexpr int kFK = 16;   // K step
constexpr int kFT = 4;    // outputs per thread along each dimension

__global__ void __launch_bounds__(256)
    gemm_tile_f32_kernel(const float* __restrict__ A,
                         const float* __restrict__ B,
                         const float* __restrict__ C, float* __restrict__ O,
                         int M, int N, int K, float alpha) {
  __shared__ float As[kFK][kFB + 4];  // A slab, stored k-major
  __shared__ float Bs[kFK][kFB + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (kFB / kFT);
  const int ty = tid / (kFB / kFT);
  const int m0 = blockIdx.y * kFB;
  const int n0 = blockIdx.x * kFB;
  float acc[kFT][kFT];
#pragma unroll
  for (int i = 0; i < kFT; ++i)
#pragma unroll
    for (int j = 0; j < kFT; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < (kFB * kFK) / 256; ++i) {
      const int e = tid + i * 256;
      const int r = e / kFK;
      const int c = e % kFK;
      const int gr = m0 + r;
      const int gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? A[static_cast<size_t>(gr) * K + gc]
                                    : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < (kFK * kFB) / 256; ++i) {
      const int e = tid + i * 256;
      const int r = e / kFB;
      const int c = e % kFB;
      const int gr = k0 + r;
      const int gc = n0 + c;
      Bs[r][c] = (gr < K && gc < N) ? B[static_cast<size_t>(gr) * N + gc]
                                    : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[kFT], b[kFT];
#pragma unroll
      for (int i = 0; i < kFT; ++i) a[i] = As[kk][ty * kFT + i];
#pragma unroll
      for (int j = 0; j < kFT; ++j) b[j] = Bs[kk][tx * kFT + j];
#pragma unroll
      for (int i = 0; i < kFT; ++i)
#pragma unroll
        for (int j = 0; j < kFT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kFT; ++i) {
#pragma unroll
    for (int j = 0; j < kFT; ++j) {
      const int gr = m0 + ty * kFT + i;
      const int gc = n0 + tx * kFT + j;
      if (gr < M && gc < N) {
        const size_t idx = static_cast<size_t>(gr) * N + gc;
        O[idx] = fmaf(alpha, acc[i][j], C[idx]);
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// cuTensorMapEncodeTiled, a libcuda entry, reached through the runtime
// so that the library does not link libcuda itself
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// TMA map of a row-major bf16 (rows, cols) matrix read in boxes of
// box_rows x box_cols, 128-byte swizzled, out-of-bounds elements zero
bool bf16_map(CUtensorMap* map, const void* base, int rows, int cols,
              int box_rows, int box_cols) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

// a cluster launch of the wgmma kernel: `blocks` blocks of kWgThreads
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  ClusterLaunch(int blocks, cudaStream_t stream) {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kWgThreads);
    cfg.dynamicSmemBytes = kWgSmem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kWgCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;  // cfg points into it
};

// once per device: lift the dynamic shared-memory limit above 48 KB and
// count the clusters that fit the card at once
cudaError_t wgmma_setup(int device, int* clusters) {
  static std::once_flag once[kMaxDevices];
  static cudaError_t err[kMaxDevices];
  static int count[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[device], [device] {
    err[device] = cudaFuncSetAttribute(
        gemm_tile_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWgSmem);
    int sms = 0;
    if (err[device] == cudaSuccess)
      err[device] = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, device);
    if (err[device] != cudaSuccess) return;
    ClusterLaunch probe(sms / kWgCluster * kWgCluster, nullptr);
    err[device] = cudaOccupancyMaxActiveClusters(
        &count[device], gemm_tile_wgmma_kernel, &probe.cfg);
    if (err[device] == cudaSuccess && count[device] < 1)
      err[device] = cudaErrorInvalidConfiguration;
  });
  *clusters = count[device];
  return err[device];
}

}  // namespace

// the wgmma route
extern "C" int parsec_gemm_tile_bf16_wgmma(const void* A, const void* B,
                                           const void* C, void* O, int M,
                                           int N, int K, float alpha,
                                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8 != 0 || N % 8 != 0 || !aligned16(A) ||
      !aligned16(B) || (reinterpret_cast<uintptr_t>(C) & 7u) != 0 ||
      (reinterpret_cast<uintptr_t>(O) & 7u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int fit = 0;
  err = wgmma_setup(device, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap ta, tb;
  if (!bf16_map(&ta, A, M, K, kWgBM, kWgBK) ||
      !bf16_map(&tb, B, K, N, kWgBK, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((M + kWgBM * kWgCluster - 1) / (kWgBM * kWgCluster)) *
                    ((N + kWgBN - 1) / kWgBN);
  ClusterLaunch launch((tiles < fit ? tiles : fit) * kWgCluster,
                       static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&launch.cfg, gemm_tile_wgmma_kernel, ta, tb,
                           static_cast<const float*>(C),
                           static_cast<float*>(O), M, N, K, alpha);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the wmma route
extern "C" int parsec_gemm_tile_bf16(const void* A, const void* B,
                                     const void* C, void* O, int M, int N,
                                     int K, float alpha, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* b = static_cast<const bf16*>(B);
  const float* c = static_cast<const float*>(C);
  float* o = static_cast<float*>(O);
  gemm_tile_bf16_kernel<<<grid, kThreads, 0, s>>>(a, b, c, o, M, N, K, alpha);
  return static_cast<int>(cudaGetLastError());
}

// the fma route (f32)
extern "C" int parsec_gemm_tile_f32(const void* A, const void* B,
                                    const void* C, void* O, int M, int N,
                                    int K, float alpha, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + kFB - 1) / kFB, (M + kFB - 1) / kFB);
  gemm_tile_f32_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(O), M, N, K, alpha);
  return static_cast<int>(cudaGetLastError());
}
