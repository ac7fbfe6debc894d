"""Published peaks of the cards the benchmark runs on (NVIDIA data sheets,
dense rates without sparsity, at the full power limit), and the card's
identity as ``nvidia-smi`` reads it."""

from __future__ import annotations

import subprocess
from typing import Dict, List, Optional

#: bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores, bytes/s
PEAKS: Dict[str, Dict[str, float]] = {
    "H100 SXM": {"bfloat16": 989e12, "float32": 67e12, "bytes": 3.35e12},
    "H100 PCIe": {"bfloat16": 756e12, "float32": 51e12, "bytes": 2.0e12},
    "H100 NVL": {"bfloat16": 835e12, "float32": 60e12, "bytes": 3.9e12},
}


def peaks_for(name: str) -> Dict[str, float]:
    """The peaks of the card named ``name`` (as
    ``torch.cuda.get_device_name`` gives it): PCIe and NVL by name, the
    SXM part otherwise."""
    for key in ("H100 PCIe", "H100 NVL"):
        if key.split()[1] in name and "H100" in name:
            return PEAKS[key]
    return PEAKS["H100 SXM"]


def smi(query: str, card: object = 0) -> Optional[str]:
    """One ``nvidia-smi --query-gpu=<query>`` reading of ``card`` (an
    index or a UUID), or None where nvidia-smi fails."""
    lines = smi_lines(query, [card])
    return lines[0] if lines else None


def smi_lines(query: str, cards: List[object]) -> List[str]:
    """One ``nvidia-smi --query-gpu=<query>`` reading of each of ``cards``
    in one call, in nvidia-smi's order; empty where nvidia-smi fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
             "-i", ",".join(str(c) for c in cards)],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if out.returncode != 0:
        return []
    return [s.strip() for s in out.stdout.strip().splitlines() if s.strip()]
