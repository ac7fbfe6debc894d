"""C += A @ B through the port's PTG GEMM.

A and B (Gaussian, in the configuration's A/B type) and C0 (Gaussian, in
C's type) are made once on the card; A and B stay placed, and every pass
hands the program fresh clones of C0's tiles through ``place_on_device``
before it builds ``apps.gemm.gemm_taskpool``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark import operands, work
from benchmark.problems import discard_device_copies, outputs_of


class Problem:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.m, self.n, self.k = (int(config[x]) for x in ("m", "n", "k"))
        self.mb = int(traffic["tile"])
        for size in (self.m, self.n, self.k):
            if size % self.mb:
                raise ValueError(f"tile {self.mb} does not divide {size}")
        self.mt, self.nt, self.kt = (s // self.mb
                                     for s in (self.m, self.n, self.k))
        self.ab_dtype = getattr(torch, config["ab_type"])
        self.c_dtype = getattr(torch, config["c_type"])
        #: the type K1's operands have: it sets the peak of its roofline
        self.k1_dtype = config["ab_type"]
        self.seed, self.device = seed, device
        self.flops_per_pass = work.gemm_flops(self.m, self.n, self.k)
        self.c_tiles = [(i, j) for i in range(self.mt)
                        for j in range(self.nt)]
        self.A = self.B = self.C = None
        self.c0: Dict[Tuple[int, int], torch.Tensor] = {}

    def tasks_per_pass(self) -> Dict[str, int]:
        return work.gemm_class_counts(self.mt, self.nt, self.kt)

    def k1_tasks_per_pass(self) -> Dict[str, int]:
        return self.tasks_per_pass()

    def k1_work(self, cls: str) -> Tuple[float, float]:
        ab = torch.tensor([], dtype=self.ab_dtype).element_size()
        c = torch.tensor([], dtype=self.c_dtype).element_size()
        return work.K1_TASK_WORK["gemm"][cls](self.mb, ab, c)

    def operands(self):
        """(A, B, C0) tiles, each from its own stream of the seed."""
        return tuple(
            operands.gaussian_tiles(rows, cols, self.mb, dtype, self.seed,
                                    stream, self.device)
            for rows, cols, dtype, stream in (
                (self.m, self.k, self.ab_dtype, operands.STREAM_A),
                (self.k, self.n, self.ab_dtype, operands.STREAM_B),
                (self.m, self.n, self.c_dtype, operands.STREAM_C)))

    def place(self, devs) -> None:
        """Every tile on the first card."""
        from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
        self.dev = dev = devs[0]
        mb = self.mb
        self.A = TwoDimBlockCyclic(mb, mb, self.m, self.k, name="A",
                                   dtype=self.ab_dtype)
        self.B = TwoDimBlockCyclic(mb, mb, self.k, self.n, name="B",
                                   dtype=self.ab_dtype)
        self.C = TwoDimBlockCyclic(mb, mb, self.m, self.n, name="C",
                                   dtype=self.c_dtype)
        a, b, self.c0 = self.operands()
        for M, tiles in ((self.A, a), (self.B, b)):
            for t, tile in tiles.items():
                M.place_on_device(*t, dev, tile)

    def restore(self) -> None:
        for t, tile in self.c0.items():
            self.C.place_on_device(*t, self.dev, tile.clone())

    def make_pool(self):
        from parsec_tpu_torch.apps.gemm import gemm_taskpool
        return gemm_taskpool(self.A, self.B, self.C)

    def pass_failed(self, tp) -> bool:
        return False

    def outputs(self) -> Dict[Tuple[int, int], torch.Tensor]:
        """C's tiles as the last pass left them."""
        return outputs_of(self.C, self.c_tiles)

    def release(self) -> None:
        discard_device_copies(self.A, [(i, j) for i in range(self.mt)
                                       for j in range(self.kt)])
        discard_device_copies(self.B, [(i, j) for i in range(self.kt)
                                       for j in range(self.nt)])
        discard_device_copies(self.C, self.c_tiles)
        self.c0 = {}
