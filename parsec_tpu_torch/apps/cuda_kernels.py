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
design, its bound and what it leaves.  Types (bf16, bf16, f32) — the GEMM
and QR paths' calls — and (f32, f32, f32); with ``trans_b`` (B given as
(n, k), ``O = C + alpha * A @ B^T``: the Cholesky updates) (bf16, bf16,
bf16) — the potrf path's calls, C read and O written in bf16 — and (f32,
f32, f32).  f32 accumulation seeded from C, one rounding to C's type;
any (m, n, k).  ``O`` is a new tensor, or with ``out=C`` C itself (in
place: the device module's buffer donation; bit-identical to the
out-of-place call).  ``gemm_route`` picks one of three hand-written routes
before launch: ``wgmma`` (bf16 wherever TMA can describe the operands),
``wmma`` (any other bf16 call) and ``fma`` (f32, never TF32).

``gemm_tile_grouped`` runs n <= ``GEMM_GROUP_MAX`` equal-shape calls (a
wave of the device module's wave fusion) as ONE persistent ``wgmma``
launch; a group whose members do not all take the ``wgmma`` route runs as
single launches on their own routes.

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
#: grouped launches of the gemm_tile kernel (``gemm_tile_grouped``, all on
#: the wgmma route) and the calls they carried; a grouped launch adds
#: nothing to ``gemm_tile_launches``, so single launches plus grouped
#: members count K1's tiles
gemm_tile_grouped_launches = Counter()
gemm_tile_grouped_members = Counter()
#: launches of the gram_tile kernels (both passes: one per call), counted
#: the same way
gram_tile_launches = Counter()

#: the most calls one grouped K1 launch carries (gemm_tile.cu's kMaxGroup)
GEMM_GROUP_MAX = 8

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
                               ctypes.c_float, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            fn = lib.parsec_gemm_tile_bf16_wgmma_grouped
            ptrs = ctypes.POINTER(ctypes.c_void_p)
            fn.argtypes = [ptrs, ptrs, ptrs, ptrs, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_float, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = lib.parsec_gram_tile_f32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_f32_matmul(what: str) -> None:
    """Refuse to build ``what`` with TF32 on: its f32 products must be
    true f32 (the reference's HIGHEST, or its f32 run on the CPU)."""
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            f"{what} needs true f32 products: switch TF32 off "
            "(torch.backends.cuda.matmul.allow_tf32 = False, "
            "torch.set_float32_matmul_precision('highest'))")


def gemm_tile_reference(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                        alpha: float = 1.0,
                        trans_b: bool = False) -> torch.Tensor:
    """Plain version of the tile kernel: ``C + alpha * (A @ B)`` (``A @
    B^T`` with ``trans_b``) with the product and the sum taken in f32 and
    rounded once to C's type, as the reference's blocked kernel seeds its
    f32 accumulator from C and casts at the end.  TF32 is switched off
    here (and stays off): the reference's f32 products are full f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    Bm = B.mT if trans_b else B
    return (C.float() + alpha * (A.float() @ Bm.float())).to(C.dtype)


#: (A, B, C, trans_b) types the kernel takes
_TYPES = {(torch.bfloat16, torch.bfloat16, torch.float32, False),
          (torch.float32, torch.float32, torch.float32, False),
          (torch.bfloat16, torch.bfloat16, torch.bfloat16, True),
          (torch.float32, torch.float32, torch.float32, True)}


def gemm_route(m: int, n: int, k: int, dtype: torch.dtype, a_ptr: int,
               b_ptr: int, c_ptr: int, trans_b: bool = False,
               c_dtype: torch.dtype = torch.float32) -> str:
    """The route ``gemm_tile`` takes for A (m, k) and B (k, n) — (n, k)
    with ``trans_b`` — of ``dtype`` and a C of ``c_dtype`` at the given
    addresses: ``"wgmma"`` where TMA can describe the bf16 operands (rows
    of a whole number of 16 bytes, 16-byte aligned bases, k > 0) and the
    epilogue can pair C's columns (n even, C aligned to a pair of its
    elements), ``"wmma"`` for any other bf16 call, ``"fma"`` for f32."""
    if dtype == torch.float32:
        return "fma"
    if dtype != torch.bfloat16:
        raise TypeError(f"gemm_route: no route for {dtype}")
    pair = 2 * (2 if c_dtype == torch.bfloat16 else 4)
    b_rows = n % 2 == 0 if trans_b else n % 8 == 0   # k % 8 covers (n, k)
    tma = (k > 0 and k % 8 == 0 and b_rows and a_ptr % 16 == 0
           and b_ptr % 16 == 0 and c_ptr % pair == 0)
    return "wgmma" if tma else "wmma"


#: the C entry of each route
_GEMM_ENTRIES = {"wgmma": "parsec_gemm_tile_bf16_wgmma",
                 "wmma": "parsec_gemm_tile_bf16",
                 "fma": "parsec_gemm_tile_f32"}


def _gemm_shape(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                trans_b: bool, out: Optional[torch.Tensor],
                what: str = "gemm_tile") -> tuple:
    """(m, n, k) of one call on CUDA tensors, after every check the kernel
    needs: one device, matrices whose shapes agree, a type set K1 takes,
    contiguous operands, and an ``out`` shaped and typed as C that is C
    itself or overlaps neither A nor B."""
    devs = {t.device for t in (A, B, C)}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{what}: A, B and C must lie on one device, "
                         f"got {A.device}, {B.device}, {C.device}")
    if A.dim() != 2 or B.dim() != 2 or C.dim() != 2:
        raise ValueError(f"{what}: A, B and C must be matrices")
    m, k = A.shape
    n, k2 = B.shape if trans_b else B.shape[::-1]
    if k2 != k or tuple(C.shape) != (m, n):
        raise ValueError(f"{what}: shapes do not agree: A {tuple(A.shape)}"
                         f", B {tuple(B.shape)}{'^T' if trans_b else ''}, "
                         f"C {tuple(C.shape)}")
    if (A.dtype, B.dtype, C.dtype, bool(trans_b)) not in _TYPES:
        raise TypeError(f"{what}: supported (A, B, C) dtypes are "
                        "(bf16, bf16, f32) and (f32, f32, f32), and with "
                        "trans_b (bf16, bf16, bf16) and (f32, f32, f32); got "
                        f"({A.dtype}, {B.dtype}, {C.dtype}), trans_b="
                        f"{bool(trans_b)}")
    if not (A.is_contiguous() and B.is_contiguous() and C.is_contiguous()):
        raise ValueError(f"{what}: A, B and C must be contiguous")
    if out is not None:
        if out.device != C.device or out.dtype != C.dtype or \
                out.shape != C.shape or not out.is_contiguous():
            raise ValueError(f"{what}: out must be a contiguous tensor "
                             "shaped, typed and placed as C")
        if (out.data_ptr() != C.data_ptr() and _overlaps(out, C)) or \
                _overlaps(out, A) or _overlaps(out, B):
            raise ValueError(f"{what}: out may be C itself but must not "
                             "overlap C, A or B otherwise")
    return m, n, k


def _overlaps(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether the bytes of two contiguous tensors overlap."""
    if x.numel() == 0 or y.numel() == 0:
        return False
    x0, y0 = x.data_ptr(), y.data_ptr()
    return x0 < y0 + y.numel() * y.element_size() and \
        y0 < x0 + x.numel() * x.element_size()


def gemm_tile(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
              alpha: float = 1.0, trans_b: bool = False,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``C + alpha * A @ B`` as a new tensor, or into ``out`` (which may be
    C itself: in place); with ``trans_b``, B is (n, k) and the product is
    ``A @ B^T``.  CPU tensors take the plain version; CUDA tensors launch
    the kernel on the current stream or raise."""
    if {t.device.type for t in (A, B, C)} == {"cpu"}:
        got = gemm_tile_reference(A, B, C, alpha, trans_b)
        return got if out is None else out.copy_(got)
    m, n, k = _gemm_shape(A, B, C, trans_b, out)
    O = torch.empty_like(C, memory_format=torch.contiguous_format) \
        if out is None else out
    if m == 0 or n == 0:
        return O        # empty output: nothing to launch, nothing counted
    # C and O must both pair-align for the wgmma epilogue: test the OR of
    # their addresses
    route = gemm_route(m, n, k, A.dtype, A.data_ptr(), B.data_ptr(),
                       C.data_ptr() | O.data_ptr(), trans_b, C.dtype)
    launch = getattr(_load(), _GEMM_ENTRIES[route])
    err = launch(A.data_ptr(), B.data_ptr(), C.data_ptr(), O.data_ptr(), m,
                 n, k, float(alpha), int(bool(trans_b)),
                 int(C.dtype == torch.bfloat16), A.device.index,
                 torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm_tile: {route} kernel launch failed with "
                           f"CUDA error {err}")
    gemm_tile_launches.add()
    gemm_tile_route_launches[route].add()
    return O


def gemm_tile_grouped_reference(As, Bs, Cs, alpha: float = 1.0,
                                trans_b: bool = False) -> list:
    """Plain version of the grouped launch: one ``gemm_tile_reference``
    per member."""
    return [gemm_tile_reference(A, B, C, alpha, trans_b)
            for A, B, C in zip(As, Bs, Cs)]


def gemm_tile_grouped(As, Bs, Cs, alpha: float = 1.0, trans_b: bool = False,
                      out=None) -> list:
    """``[C_i + alpha * A_i @ B_i]`` (``B_i^T`` with ``trans_b``) over n
    equal-shape calls, as new tensors or into ``out`` (a list; ``out[i]``
    may be ``Cs[i]``).  On CUDA tensors the calls run as one persistent
    ``wgmma`` launch per ``GEMM_GROUP_MAX`` members when every member
    takes that route, and as single launches on their own routes
    otherwise; a failed grouped launch raises.  CPU tensors take the
    plain version."""
    As, Bs, Cs = list(As), list(Bs), list(Cs)
    outs = [None] * len(Cs) if out is None else list(out)
    if not len(As) == len(Bs) == len(Cs) == len(outs):
        raise ValueError("gemm_tile_grouped: As, Bs, Cs and out must have "
                         "one entry per call")
    if all(t.device.type == "cpu" for t in (*As, *Bs, *Cs)):
        got = gemm_tile_grouped_reference(As, Bs, Cs, alpha, trans_b)
        return [g if o is None else o.copy_(g) for g, o in zip(got, outs)]
    shapes = [_gemm_shape(A, B, C, trans_b, o, "gemm_tile_grouped")
              for A, B, C, o in zip(As, Bs, Cs, outs)]
    first = (As[0].dtype, Cs[0].dtype, As[0].device)
    if any(s != shapes[0] for s in shapes) or \
            any((A.dtype, C.dtype, A.device) != first
                for A, C in zip(As, Cs)):
        raise ValueError("gemm_tile_grouped: the calls must share one "
                         "shape, one type set and one device")
    m, n, k = shapes[0]
    Os = [torch.empty_like(C, memory_format=torch.contiguous_format)
          if o is None else o for C, o in zip(Cs, outs)]
    if len(Cs) == 1 or any(
            gemm_route(m, n, k, A.dtype, A.data_ptr(), B.data_ptr(),
                       C.data_ptr() | O.data_ptr(), trans_b, C.dtype)
            != "wgmma" for A, B, C, O in zip(As, Bs, Cs, Os)):
        return [gemm_tile(A, B, C, alpha, trans_b, out=O)
                for A, B, C, O in zip(As, Bs, Cs, Os)]
    if m == 0 or n == 0:
        return Os       # empty outputs: nothing to launch, nothing counted
    launch = _load().parsec_gemm_tile_bf16_wgmma_grouped
    dev = As[0].device
    for lo in range(0, len(Cs), GEMM_GROUP_MAX):
        hi = min(lo + GEMM_GROUP_MAX, len(Cs))
        ptrs = [(ctypes.c_void_p * (hi - lo))(*(t.data_ptr()
                                                 for t in ts[lo:hi]))
                for ts in (As, Bs, Cs, Os)]
        err = launch(*ptrs, hi - lo, m, n, k, float(alpha),
                     int(bool(trans_b)), int(Cs[0].dtype == torch.bfloat16),
                     dev.index, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"gemm_tile_grouped: grouped wgmma launch of "
                               f"{hi - lo} calls failed with CUDA error "
                               f"{err}")
        gemm_tile_grouped_launches.add()
        gemm_tile_grouped_members.add(hi - lo)
    return Os


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
