"""Hand-written Hopper kernels for the hot tile operations, with their
plain PyTorch versions.

Every ``csrc/*.cu`` source is compiled at first use with ``nvcc`` (one
process per source, all started together) and linked into one shared
library under ``parsec_tpu_torch/_build/``, named by a hash over all the
sources; it is bound through a plain C interface with ``ctypes``.

``gemm_tile`` — the GEMM-accumulate tile ``O = C + alpha * A @ B``
--------------------------------------------------------------------

Replaces ``parsec_tpu/apps/pallas_kernels.py::pallas_gemm_tile`` (the
blocked Pallas program over ``_blocked_matmul``).  Source:
``parsec_tpu_torch/csrc/gemm_tile.cu``, CUDA C++ for ``sm_90a``.

Types: (bf16, bf16, f32) — the tiled-GEMM main path — and (f32, f32, f32).
Accumulation is f32; alpha is a runtime scalar; any (m, n, k), the ragged
edge masked inside the kernel, so there is no unaligned-shape fallback.
bf16 runs on the tensor cores (WMMA m16n16k16, f32 accumulators) from
shared-memory tiles filled by a double-buffered ``cp.async`` pipeline
(128x128x32 block tiles, 8 warps of 64x32).  f32 runs on plain f32 FMA,
never TF32, to keep the reference's f32 semantics.  The K loop runs inside
the block: it takes the place of the TPU program's sequential K grid axis
and its scratch accumulator, since CUDA blocks run in no order.  The
kernel allocates nothing (the wrapper makes ``O`` with ``torch.empty``)
and is functional: ``O`` never aliases ``C``.

Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the main
path's 12288^3 tile the work is 2 * 12288^3 = 3.71e12 flop, 3.75 ms at the
tensor-core peak, against 1.81 GB of traffic (A and B once in bf16, C read
and O written in f32), 0.54 ms at the memory rate — compute-bound.  A PCIe
card has lower peaks; ``chip_smoke.py`` prints the bound it uses.

What the simple design leaves on the table: ``mma.sync``-class WMMA cannot
reach Hopper's full tensor-core rate — that needs ``wgmma`` fed by TMA
loads, a deeper ring of stages and warp-specialised producer/consumer
warps, persistent blocks and a swizzled shared layout instead of padding;
the epilogue goes through a per-warp shared scratch.  Those are for a
later change; the measured times stand in PERF.md.

``gram_tile`` — the f32 Gram matrix ``G = X^T X``
-------------------------------------------------

Replaces ``parsec_tpu/apps/pallas_kernels.py::pallas_gram_tile`` (the
blocked Pallas program over ``_blocked_gram``, run at HIGHEST precision).
Source: ``parsec_tpu_torch/csrc/gram_tile.cu``.  X is f32 (m, n), G the
full (n, n) f32 matrix, any shape.  Plain f32 FMA, never TF32: G feeds
the QR panel's Cholesky, whose error grows as cond^2.  Upper 32x32 tiles
only, mirrored; the rows of X split among four k-groups inside a block.
Bound on an H100 SXM at the QR path's 6144 x 512: m*n*(n+1) = 1.61e9 flop,
0.024 ms at 67 TFLOP/s f32, against 13.6 MB (0.004 ms) — operation-bound.

Each ``*_reference`` is the plain version: the same function in PyTorch
with TF32 switched off.  A wrapper takes it only for CPU tensors; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
#: nvcc target: the ``a`` keeps Hopper-only instructions available
NVCC_ARCH = "-gencode=arch=compute_90a,code=sm_90a"


class Counter:
    """Thread-safe integer count (kernel launches, guard fallbacks)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def reset(self) -> None:
        with self._lock:
            self.value = 0


#: launches of the gemm_tile kernel; the wrapper adds one per launch and
#: nowhere else (CPU calls take the plain version and do not count)
gemm_tile_launches = Counter()
#: launches of the gram_tile kernel, counted the same way
gram_tile_launches = Counter()

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
#: seconds the last build took (0.0 when a built library was reused)
last_build_seconds = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build parsec_tpu_torch's kernels")
    return found


def sources() -> list:
    """Every kernel source of the port, in a fixed order."""
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library of the current sources lives: its name is a hash
    over the target and every ``csrc/*.cu``, so any edit rebuilds."""
    h = hashlib.sha256(NVCC_ARCH.encode())
    for src in sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return _BUILD_DIR / f"libparsec_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` into one shared library unless it is
    already built; return its path.  Each source compiles in its own
    ``nvcc`` process, all started together, then one ``nvcc`` links the
    objects.  ``verbose`` prints ptxas's register and shared-memory
    report."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        last_build_seconds = 0.0
        return out
    nvcc = _nvcc()
    flags = [NVCC_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    if verbose:
        flags += ["-Xptxas", "-v"]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as work:
        jobs = [(src, os.path.join(work, src.stem + ".o"))
                for src in sources()]
        procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", obj, str(src)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in jobs]
        failed = []
        for (src, _), proc in zip(jobs, procs):
            err = proc.communicate()[1]
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{err}")
            elif verbose and err:
                print(f"{src.name}:\n{err}", flush=True)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = os.path.join(work, out.name)
        res = subprocess.run([nvcc, NVCC_ARCH, "-shared", "-o", lib,
                              *(obj for _, obj in jobs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(lib, out)
    last_build_seconds = time.perf_counter() - t0
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name in ("parsec_gemm_tile_bf16", "parsec_gemm_tile_f32"):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_float, ctypes.c_int,
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
            fn = lib.parsec_gram_tile_f32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def gemm_tile_reference(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                        alpha: float = 1.0) -> torch.Tensor:
    """Plain version of the tile kernel: ``C + alpha * (A @ B)`` with the
    product taken in f32.  TF32 is switched off here (and stays off):
    the reference's f32 products are full f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return C + alpha * (A.float() @ B.float()).to(C.dtype)


_TYPES = {(torch.bfloat16, torch.bfloat16, torch.float32):
          "parsec_gemm_tile_bf16",
          (torch.float32, torch.float32, torch.float32):
          "parsec_gemm_tile_f32"}


def gemm_tile(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
              alpha: float = 1.0) -> torch.Tensor:
    """``C + alpha * A @ B`` as a new tensor.  CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream or
    raise."""
    devs = {t.device.type for t in (A, B, C)}
    if devs == {"cpu"}:
        return gemm_tile_reference(A, B, C, alpha)
    if devs != {"cuda"} or not (A.device == B.device == C.device):
        raise ValueError("gemm_tile: A, B and C must lie on one device, "
                         f"got {A.device}, {B.device}, {C.device}")
    if A.dim() != 2 or B.dim() != 2 or C.dim() != 2:
        raise ValueError("gemm_tile: A, B and C must be matrices")
    m, k = A.shape
    k2, n = B.shape
    if k2 != k or tuple(C.shape) != (m, n):
        raise ValueError(f"gemm_tile: shapes do not agree: A {tuple(A.shape)}"
                         f", B {tuple(B.shape)}, C {tuple(C.shape)}")
    fname = _TYPES.get((A.dtype, B.dtype, C.dtype))
    if fname is None:
        raise TypeError("gemm_tile: supported (A, B, C) dtypes are "
                        "(bf16, bf16, f32) and (f32, f32, f32), got "
                        f"({A.dtype}, {B.dtype}, {C.dtype})")
    if not (A.is_contiguous() and B.is_contiguous() and C.is_contiguous()):
        raise ValueError("gemm_tile: A, B and C must be contiguous")
    O = torch.empty_like(C, memory_format=torch.contiguous_format)
    if m == 0 or n == 0:
        return O        # empty output: nothing to launch, nothing counted
    fn = getattr(_load(), fname)
    err = fn(A.data_ptr(), B.data_ptr(), C.data_ptr(), O.data_ptr(),
             m, n, k, float(alpha), A.device.index,
             torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm_tile: kernel launch failed with CUDA "
                           f"error {err}")
    gemm_tile_launches.add()
    return O


def gram_tile_reference(X: torch.Tensor) -> torch.Tensor:
    """Plain version of the Gram kernel: ``X^T X`` in f32, TF32 switched
    off (and left off): the reference runs this product at HIGHEST."""
    torch.backends.cuda.matmul.allow_tf32 = False
    Xf = X.float()
    return Xf.T @ Xf


def gram_tile(X: torch.Tensor) -> torch.Tensor:
    """``X^T X`` of an f32 matrix as a new (n, n) f32 tensor.  CPU tensors
    take the plain version; CUDA tensors launch the kernel on the current
    stream or raise."""
    if X.device.type == "cpu":
        return gram_tile_reference(X)
    if X.device.type != "cuda":
        raise ValueError(f"gram_tile: X must lie on the CPU or a CUDA "
                         f"device, got {X.device}")
    if X.dim() != 2:
        raise ValueError(f"gram_tile: X must be a matrix, got "
                         f"{tuple(X.shape)}")
    if X.dtype != torch.float32:
        raise TypeError(f"gram_tile: X must be float32, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("gram_tile: X must be contiguous")
    m, n = X.shape
    G = torch.empty((n, n), dtype=torch.float32, device=X.device)
    if n == 0:
        return G        # empty output: nothing to launch, nothing counted
    err = _load().parsec_gram_tile_f32(
        X.data_ptr(), G.data_ptr(), m, n, X.device.index,
        torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gram_tile: kernel launch failed with CUDA "
                           f"error {err}")
    gram_tile_launches.add()
    return G
