"""The tiled Cholesky factorization through the port's PTG.

The operand (``operands.spd_lower_tiles``) is made once on the card; its
lower tiles stay there as the pristine copy, and every pass hands the
program fresh clones of them through ``place_on_device`` before it builds
``apps.potrf.potrf_taskpool`` over them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark import operands, work
from benchmark.problems import discard_device_copies, outputs_of


class Problem:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.n = int(config["n"])
        self.mb = int(traffic["tile"])
        if self.n % self.mb:
            raise ValueError(f"tile {self.mb} does not divide n {self.n}")
        self.nt = self.n // self.mb
        self.dtype = getattr(torch, config["storage"])
        #: the type K1's operands have: it sets the peak of its roofline
        self.k1_dtype = config["storage"]
        self.diag = float(config["diagonal"])
        self.seed, self.device = seed, device
        self.flops_per_pass = work.potrf_flops(self.n)
        self.lower = [(m, k) for m in range(self.nt) for k in range(m + 1)]
        self.A = None
        self.pristine: Dict[Tuple[int, int], torch.Tensor] = {}

    def tasks_per_pass(self) -> Dict[str, int]:
        return work.potrf_class_counts(self.nt)

    def k1_tasks_per_pass(self) -> Dict[str, int]:
        counts = self.tasks_per_pass()
        return {c: counts[c] for c in work.K1_TASK_WORK["potrf"]}

    def k1_work(self, cls: str) -> Tuple[float, float]:
        size = torch.tensor([], dtype=self.dtype).element_size()
        return work.K1_TASK_WORK["potrf"][cls](self.mb, size, size)

    def operand(self) -> Dict[Tuple[int, int], torch.Tensor]:
        return operands.spd_lower_tiles(self.n, self.mb, self.dtype,
                                        self.seed, self.device, self.diag)

    def place(self, dev) -> None:
        from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
        self.dev = dev
        self.A = TwoDimBlockCyclic(self.mb, self.mb, self.n, self.n,
                                   name="A", dtype=self.dtype)
        self.pristine = self.operand()

    def restore(self) -> None:
        for t, tile in self.pristine.items():
            self.A.place_on_device(*t, self.dev, tile.clone())

    def make_pool(self):
        from parsec_tpu_torch.apps.potrf import potrf_taskpool
        return potrf_taskpool(self.A)

    def pass_failed(self, tp) -> bool:
        return tp.cholesky_check.failed()

    def outputs(self) -> Dict[Tuple[int, int], torch.Tensor]:
        """The factor L's lower tiles as the last pass left them."""
        return outputs_of(self.A, self.lower)

    def release(self) -> None:
        discard_device_copies(self.A, self.lower)
        self.pristine = {}
