"""Device registry and module base: accelerator seam of the runtime.

Rebuild of the reference's device MCA framework (reference:
parsec/mca/device/device.h:115-148 module vtable, device.c:79-140
``parsec_get_best_device`` and load counters device.h:159-162): devices
register with the runtime, carry a relative compute weight and a live load,
expose per-device statistics, and the engine picks the best device for a
task by data affinity first, then weighted load.

Memory spaces: space 0 is host RAM; each attached accelerator device gets
the next space index.  DataCopy.device is a memory-space index into this
registry.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from parsec_tpu_torch.core.task import HookReturn, Task
from parsec_tpu_torch.data.data import ACCESS_WRITE, Coherency


class DeviceStats:
    """Per-device counters (reference: device.h:132-137)."""

    __slots__ = ("executed_tasks", "bytes_in", "bytes_out", "faults",
                 "evictions", "fused_launches", "fused_tasks",
                 "chained_launches", "chained_tasks", "donated_tasks",
                 "donations_refused")

    def __init__(self):
        self.executed_tasks = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.faults = 0
        self.evictions = 0
        #: wavefront launch fusion counters: waves of more than one task
        #: run in one manager step behind one launch event, and how many
        #: tasks rode them (devices/cuda.py manager batching)
        self.fused_launches = 0
        self.fused_tasks = 0
        #: cross-panel chain fusion counters: launches that ran a held
        #: panel chain in front of a consumer wave (or alone, when forced),
        #: and how many tasks (held + wave) rode them (device_fuse_panel)
        self.chained_launches = 0
        self.chained_tasks = 0
        #: buffer donation: tasks whose written flows were handed their
        #: staged inputs as output storage, and launches that could have
        #: donated but were refused by a hazard (device_donate)
        self.donated_tasks = 0
        self.donations_refused = 0

    def as_dict(self) -> Dict[str, int]:
        return {k: getattr(self, k) for k in self.__slots__}


class Device:
    """Device module base (reference: parsec_device_module_t).

    ``space`` is the memory-space index (0 = host); ``weight`` is the
    relative throughput used for load balancing (reference: device
    gflops weights); ``load`` counts outstanding work units.
    """

    kind = "base"

    def __init__(self, name: str):
        self.name = name
        self.space = -1          # assigned by the registry
        #: the DeviceRegistry this module is attached to (set by attach):
        #: a module reads its peers' launch streams through it
        self.registry = None
        self.weight = 1.0
        self.load = 0.0
        self._load_lock = threading.Lock()
        self.stats = DeviceStats()
        self.enabled = True
        #: extensible per-device info slots (reference: class/info.h
        #: object arrays on device modules)
        from parsec_tpu_torch.utils.info import InfoObjectArray, \
            device_info
        self.info = InfoObjectArray(device_info, owner=self)

    # -- load accounting (reference: parsec_device_load/sload) ------------
    def load_add(self, units: float) -> None:
        with self._load_lock:
            self.load += units

    def load_sub(self, units: float) -> None:
        with self._load_lock:
            self.load = max(0.0, self.load - units)

    # -- module vtable -----------------------------------------------------
    def submit(self, es, task: Task, spec: Any) -> HookReturn:
        """Take ownership of a device task; return ASYNC on success."""
        raise NotImplementedError

    def flush(self) -> None:
        """Write every dirty device copy back to its host datum."""

    def fini(self) -> None:
        """Stop device threads and release resources."""

    def __repr__(self):
        return f"<Device {self.name} space={self.space} load={self.load:.1f}>"


class HostDevice(Device):
    """Memory space 0: host RAM + inline CPU execution (reference: the
    implicit CPU device, PARSEC_DEV_CPU)."""

    kind = "cpu"

    def __init__(self):
        super().__init__("cpu")
        self.space = 0


class DeviceRegistry:
    """Process-wide device table (reference: parsec_mca_device_* in
    device.c)."""

    def __init__(self, context=None):
        self.context = context
        self.host = HostDevice()
        self.devices: List[Device] = [self.host]

    def attach(self, dev: Device) -> Device:
        """reference: parsec_mca_device_add (device.h:186)."""
        dev.space = len(self.devices)
        dev.registry = self
        self.devices.append(dev)
        return dev

    @property
    def accelerators(self) -> List[Device]:
        return [d for d in self.devices[1:] if d.enabled]

    def get(self, space: int) -> Device:
        return self.devices[space]

    def best_device(self, task: Task) -> Optional[Device]:
        """Pick the execution device for a task (reference:
        parsec_get_best_device, device.c:79-140): honor the owner/preferred
        device of the task's written data when it is an accelerator,
        otherwise the enabled accelerator with the least weighted load.

        A pool carrying a serving-fabric carve stamp
        (``Taskpool.device_spaces``) restricts every choice — affinity
        hints included — to its carved subset, so concurrent tenants
        never share an exclusively-placed device."""
        allowed = getattr(task.taskpool, "device_spaces", None)
        accs = self.accelerators
        if allowed is not None:
            accs = [d for d in accs if d.space in allowed]
        if not accs:
            return None
        dev = self._coaffinity_device(task)
        if dev is not None and (allowed is None or dev.space in allowed):
            return dev
        for flow in task.task_class.flows:
            if not (flow.access & ACCESS_WRITE):
                continue
            copy = task.data.get(flow.name)
            if copy is None or copy.data is None:
                continue
            datum = copy.data
            pref = datum.preferred_device
            if pref is not None and 1 <= pref < len(self.devices) \
                    and self.devices[pref].enabled \
                    and (allowed is None or pref in allowed):
                return self.devices[pref]
            # residency affinity: the accelerator already holding the
            # newest valid copy of the written datum wins, avoiding a
            # cross-device migration per write
            v = datum.newest_version()
            for sp, c in datum.copies().items():
                if sp >= 1 and sp < len(self.devices) \
                        and c.coherency != Coherency.INVALID \
                        and c.version == v and c.payload is not None \
                        and self.devices[sp].enabled \
                        and (allowed is None or sp in allowed):
                    return self.devices[sp]
        return min(accs, key=lambda d: d.load / d.weight)

    def _coaffinity_device(self, task: Task) -> Optional[Device]:
        """Panel co-location hint: a task class carrying a 'coaffinity'
        property (locals -> data ref) prefers the device holding that
        datum — e.g. TRSM(m,k)/TSQRT(m,k) follow their panel's diagonal
        tile A(k,k), so the POTRF->TRSM / TSQRT column chain stays on
        ONE device and cross-panel chain fusion (devices/cuda.py
        device_fuse_panel, which also gates this hint) can run it in a
        single launch step."""
        coaff = task.task_class.properties.get("coaffinity")
        if coaff is None:
            return None
        from parsec_tpu_torch.utils.mca import params
        try:
            if not int(params.get("device_fuse_panel", 1)):
                return None
            datum = coaff(task.locals).resolve()
        except Exception:
            return None
        pref = datum.preferred_device
        if pref is not None and 1 <= pref < len(self.devices) \
                and self.devices[pref].enabled:
            return self.devices[pref]
        v = datum.newest_version()
        for sp, c in datum.copies().items():
            if 1 <= sp < len(self.devices) \
                    and c.coherency != Coherency.INVALID \
                    and c.version == v and c.payload is not None \
                    and self.devices[sp].enabled:
                return self.devices[sp]
        return None

    def flush_all(self) -> None:
        for d in self.devices[1:]:
            d.flush()

    def fini(self) -> None:
        for d in self.devices[1:]:
            d.fini()

    def dump_stats(self) -> Dict[str, Dict[str, int]]:
        """reference: parsec_mca_device_dump_and_reset_statistics."""
        return {d.name: d.stats.as_dict() for d in self.devices}
