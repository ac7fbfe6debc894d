"""The tiled Cholesky factorization through the port's PTG.

The operand (``operands.spd_lower_tiles``) is made once on the card; its
lower tiles stay there as the pristine copy, and every pass hands the
program fresh clones of them through ``place_on_device`` before it builds
``apps.potrf.potrf_taskpool`` over them.  Over several cards each tile is
made, kept and handed over on the card that the program's
``distribute_devices`` deals it to, which is also its preferred device.
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
        #: the module each lower tile is kept on; more than one: spread
        self.home: Dict[Tuple[int, int], object] = {}
        self.spread = False
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
        homes = None if not self.spread else \
            {t: dev.tdev for t, dev in self.home.items()}
        return operands.spd_lower_tiles(self.n, self.mb, self.dtype,
                                        self.seed, self.device, self.diag,
                                        homes)

    def place(self, devs) -> None:
        from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
        self.A = TwoDimBlockCyclic(self.mb, self.mb, self.n, self.n,
                                   name="A", dtype=self.dtype)
        self.spread = len(devs) > 1
        self.home = self.dealt(devs) if self.spread else \
            {t: devs[0] for t in self.lower}
        self.pristine = self.operand()

    def dealt(self, devs) -> Dict[Tuple[int, int], object]:
        """The module each lower tile goes to as ``distribute_devices``
        deals A's tile grid over ``devs``: read off a grid of one-element
        tiles of A's shape, so no host storage is made for A's tiles."""
        from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
        grid = TwoDimBlockCyclic(1, 1, self.nt, self.nt, name="grid")
        grid.distribute_devices([d.space for d in devs])
        by_space = {d.space: d for d in devs}
        return {t: by_space[grid.data_of(*t).preferred_device]
                for t in self.lower}

    def restore(self) -> None:
        for t, tile in self.pristine.items():
            d = self.A.place_on_device(*t, self.home[t], tile.clone())
            if self.spread:
                d.preferred_device = self.home[t].space

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
