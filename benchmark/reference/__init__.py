"""Plain references, one module per problem, in PyTorch alone: no import of
the program, nothing the program made.  Each regenerates its operands from
the seed (``benchmark.operands``) and works the result out again, with TF32
off.  Each module has:

* ``check(config, traffic, seed, devices, outputs)``: the numbers
  that decide ``correct``, comparing the program's output tiles with the
  reference's;
* ``control(config, traffic, seed, devices)``: the same numbers for
  the reference computed in the next precision below the configuration's,
  put in the program's place (``correct`` has to come out false for it);
* ``NUMBERS``: the names of those numbers.

``devices`` is the list of the cell's cards as ``torch.device``s, first
card first; a reference that uses one card takes the first.
"""

from __future__ import annotations

import math

import torch


def no_tf32() -> None:
    """Every f32 product a full f32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 storage with one scale, back in f32: the
    control's storage, the next precision below bf16.  The scale is the
    power of two that puts the largest magnitude in (224, 448], e4m3's top
    binade, so every value it gives is a bf16 value too."""
    amax = float(x.abs().amax())
    scale = 2.0 ** math.ceil(math.log2(amax / 448.0)) if amax > 0 else 1.0
    y = x.to(torch.float32, copy=True).div_(scale).to(torch.float8_e4m3fn)
    return y.float().mul_(scale)


def worse(a: float, b: float) -> float:
    """The larger of two gaps, where NaN counts as the largest."""
    if math.isnan(a) or math.isnan(b):
        return math.inf
    return max(a, b)
