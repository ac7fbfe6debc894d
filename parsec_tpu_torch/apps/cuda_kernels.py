"""Hand-written Hopper kernels for the hot tile operations, with their
plain PyTorch versions.

Every ``csrc/*.cu`` source is compiled at first use with ``nvcc`` (one
process per source, all started together) and linked into one shared
library under ``parsec_tpu_torch/_build/``, named by a hash over all the
sources; it is bound through a plain C interface with ``ctypes``.

``gemm_tile`` — the GEMM-accumulate tile ``O = C + alpha * A @ B``
--------------------------------------------------------------------

Replaces ``parsec_tpu/apps/pallas_kernels.py::pallas_gemm_tile``.
Source: ``parsec_tpu_torch/csrc/gemm_tile.cu``, whose header holds the
design, its bound and what it leaves.  Types (bf16, bf16, f32) — every
path's call — and (f32, f32, f32); f32 accumulation; any (m, n, k); ``O``
is a new tensor that never aliases ``C``.  ``gemm_route`` picks one of
three hand-written routes before launch: ``wgmma`` (bf16 wherever TMA
can describe the operands), ``wmma`` (any other bf16 call) and ``fma``
(f32, never TF32).

``gram_tile`` — the f32 Gram matrix ``G = X^T X``
-------------------------------------------------

Replaces ``parsec_tpu/apps/pallas_kernels.py::pallas_gram_tile`` (run at
HIGHEST precision).  Source: ``parsec_tpu_torch/csrc/gram_tile.cu``, whose
header holds the design.  Plain f32 FMA, never TF32, split-K over the
rows of X by ``gram_split_plan``, the partials in scratch the wrapper
makes and summed in a fixed order, so two calls give bit-identical G.

Each ``*_reference`` is the plain version: the same function in PyTorch
with TF32 switched off.  A wrapper takes it only for CPU tensors; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
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
#: the same launches by route (``gemm_route``): each launch adds one to
#: ``gemm_tile_launches`` and one to its route's count
gemm_tile_route_launches = {"wgmma": Counter(), "wmma": Counter(),
                            "fma": Counter()}
#: launches of the gram_tile kernels (both passes: one per call), counted
#: the same way
gram_tile_launches = Counter()

#: the Gram kernel's output tile, rows of X per stage and blocks per SM:
#: copies of gram_tile.cu's kT, kKC and kBlocksPerSM, which the split plan
#: and the scratch size need (a test holds them equal)
GRAM_TILE = 64
GRAM_STAGE_ROWS = 16
GRAM_BLOCKS_PER_SM = 6

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
            for name in ("parsec_gemm_tile_bf16_wgmma",
                         "parsec_gemm_tile_bf16", "parsec_gemm_tile_f32"):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_float, ctypes.c_int,
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
            fn = lib.parsec_gram_tile_f32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
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


_TYPES = {(torch.bfloat16, torch.bfloat16, torch.float32),
          (torch.float32, torch.float32, torch.float32)}


def gemm_route(m: int, n: int, k: int, dtype: torch.dtype, a_ptr: int,
               b_ptr: int, c_ptr: int) -> str:
    """The route ``gemm_tile`` takes for A (m, k) and B (k, n) of
    ``dtype`` and an f32 C at the given addresses: ``"wgmma"`` where TMA
    can describe the bf16 operands (rows of a whole number of 16 bytes,
    16-byte aligned bases, k > 0) and C is 8-byte aligned for the
    epilogue's paired loads, ``"wmma"`` for any other bf16 call, ``"fma"``
    for f32."""
    if dtype == torch.float32:
        return "fma"
    if dtype != torch.bfloat16:
        raise TypeError(f"gemm_route: no route for {dtype}")
    tma = (k > 0 and k % 8 == 0 and n % 8 == 0 and a_ptr % 16 == 0
           and b_ptr % 16 == 0 and c_ptr % 8 == 0)
    return "wgmma" if tma else "wmma"


#: the C entry of each route
_GEMM_ENTRIES = {"wgmma": "parsec_gemm_tile_bf16_wgmma",
                 "wmma": "parsec_gemm_tile_bf16",
                 "fma": "parsec_gemm_tile_f32"}


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
    if (A.dtype, B.dtype, C.dtype) not in _TYPES:
        raise TypeError("gemm_tile: supported (A, B, C) dtypes are "
                        "(bf16, bf16, f32) and (f32, f32, f32), got "
                        f"({A.dtype}, {B.dtype}, {C.dtype})")
    if not (A.is_contiguous() and B.is_contiguous() and C.is_contiguous()):
        raise ValueError("gemm_tile: A, B and C must be contiguous")
    O = torch.empty_like(C, memory_format=torch.contiguous_format)
    if m == 0 or n == 0:
        return O        # empty output: nothing to launch, nothing counted
    route = gemm_route(m, n, k, A.dtype, A.data_ptr(), B.data_ptr(),
                       C.data_ptr())
    launch = getattr(_load(), _GEMM_ENTRIES[route])
    err = launch(A.data_ptr(), B.data_ptr(), C.data_ptr(), O.data_ptr(), m,
                 n, k, float(alpha), A.device.index,
                 torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm_tile: {route} kernel launch failed with "
                           f"CUDA error {err}")
    gemm_tile_launches.add()
    gemm_tile_route_launches[route].add()
    return O


def gram_upper_tiles(n: int) -> int:
    """Upper ``GRAM_TILE``-square tiles of an (n, n) Gram matrix."""
    nb = -(-n // GRAM_TILE)
    return nb * (nb + 1) // 2


def gram_split_plan(m: int, n: int, sms: int) -> tuple:
    """``(splits, rows_per_split)`` for the Gram kernel over X (m, n): the
    rows cut into ``splits`` runs of ``rows_per_split`` rows (a whole
    number of stages), the last one possibly shorter and none empty, as
    many as the upper tiles allow within ``GRAM_BLOCKS_PER_SM`` blocks on
    each of ``sms`` SMs (one wave, no tail).  m = 0 gives one empty
    run."""
    stages = max(1, -(-m // GRAM_STAGE_ROWS))
    want = GRAM_BLOCKS_PER_SM * sms // gram_upper_tiles(n)
    splits = max(1, min(stages, want, 65535))
    rows = -(-stages // splits) * GRAM_STAGE_ROWS
    return max(1, -(-m // rows)), rows


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    splits, rows = gram_split_plan(m, n, _sm_count(X.device.index))
    tiles = gram_upper_tiles(n)
    partials = torch.empty((splits, tiles, GRAM_TILE, GRAM_TILE),
                           dtype=torch.float32, device=X.device)
    err = _load().parsec_gram_tile_f32(
        X.data_ptr(), G.data_ptr(), partials.data_ptr(), partials.numel(), m,
        n, splits, rows, X.device.index,
        torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gram_tile: kernel launch failed with CUDA "
                           f"error {err}")
    gram_tile_launches.add()
    return G
