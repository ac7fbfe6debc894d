"""Device layer: registry + the CUDA device module.

reference: parsec/mca/device/ — see device.py and cuda.py in this package.
"""

from __future__ import annotations

from typing import Optional

from parsec_tpu_torch.devices.device import Device, DeviceRegistry, \
    DeviceStats
from parsec_tpu_torch.utils.mca import params
from parsec_tpu_torch.utils.output import debug_verbose

params.register("device", "cuda",
                "where device bodies run: 'cuda' attaches every visible "
                "CUDA device and fails without one; 'cuda*N' attaches N "
                "modules over card 0 (each its own launch stream and 1/N "
                "of the card's free memory); 'cpu' attaches one "
                "CPU-backed instance of the same device module and "
                "'cpu:N' attaches N of them (tests)")


def init_devices(context, device: Optional[str] = None) -> DeviceRegistry:
    """Attach the device modules a context runs on (reference:
    parsec_mca_device_init/attach, parsec.c:823-828).

    ``device`` (else the MCA param of that name): "cuda" attaches one
    module per visible CUDA device and raises RuntimeError when there is
    none — nothing carries on on the CPU because CUDA is missing; "cpu"
    attaches one CPU-backed module, whose streams and events are no-ops
    and whose kernels resolve to their plain versions, and "cpu:N"
    attaches N of them (N memory spaces over the one host memory: the
    counterpart of the JAX package's tests' 8-device CPU mesh, which the
    serving fabric carves).  "cuda*N" attaches N modules over card 0,
    the card's counterpart of "cpu:N": each module has its own launch
    stream, memory space, LRU and a 1/N budget of the card's free
    memory, so a pool spread over them moves tiles between modules
    (comm/ici.py) as the JAX package's does between its 8 devices;
    "cuda*1" is "cuda" on card 0."""
    import torch
    from parsec_tpu_torch.devices.cuda import CudaDevice
    kind = str(device if device is not None
               else params.get("device", "cuda")).lower()
    reg = DeviceRegistry(context)
    if kind == "cpu" or kind.startswith("cpu:"):
        n = _count(kind, "cpu:")
        for i in range(n):
            reg.attach(CudaDevice(torch.device("cpu"), index=i))
        return reg
    shared = kind.startswith("cuda*")
    if kind not in ("cuda", "gpu") and not shared:
        raise ValueError(
            f"device must be 'cuda', 'cuda*N', 'cpu' or 'cpu:N', not "
            f"{kind!r}")
    m = _count(kind, "cuda*") if shared else 0
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' (or --mca "
            "device cpu) to run the device module on the CPU")
    if shared:
        card = torch.device("cuda", 0)
        for i in range(m):
            reg.attach(CudaDevice(card, index=i, modules=m))
        debug_verbose(3, "attached %d modules over one CUDA device (%s)",
                      m, torch.cuda.get_device_name(0))
        return reg
    for i in range(n):
        reg.attach(CudaDevice(torch.device("cuda", i)))
    debug_verbose(3, "attached %d CUDA devices (%s)", n,
                  torch.cuda.get_device_name(0))
    return reg


def _count(kind: str, prefix: str) -> int:
    """N of "cpu:N" or "cuda*N" (1 for "cpu"); anything else raises."""
    if kind == "cpu":
        return 1
    try:
        n = int(kind[len(prefix):])
    except ValueError:
        n = 0
    if n < 1:
        raise ValueError(f"device {kind!r}: '{prefix}N' needs N >= 1")
    return n


__all__ = ["Device", "DeviceRegistry", "DeviceStats", "init_devices"]
