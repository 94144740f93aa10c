"""Device selection and memory accounting (twin of
``gpusimilarity_tpu/parallel/mesh.py``).

The port runs one library shard on one device, so the mesh reduces to a
``torch.device``. A CUDA device that is not there raises: nothing quietly
falls back to the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch


def select_device(cpu_only: bool = False) -> torch.device:
    """``cuda`` (the first card) unless ``cpu_only``; raises without a GPU."""
    if cpu_only:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass --cpu_only to run the plain "
            "PyTorch path on the host"
        )
    return torch.device("cuda", 0)


def available_device_memory(device: torch.device) -> Optional[int]:
    """Free device memory in bytes, or None on the CPU (no meaningful cap)."""
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return int(free)


def auto_fold_factor(
    db_bytes: int, device: torch.device, reserve_fraction: float = 0.25
) -> int:
    """Smallest fold factor that fits ``db_bytes`` into free device memory,
    keeping ``reserve_fraction`` for workspace (reference
    ``gpusim.cpp:119-143``)."""
    free = available_device_memory(device)
    if free is None or db_bytes == 0:
        return 1
    usable = int(free * (1.0 - reserve_fraction))
    if usable <= 0:
        raise MemoryError("no usable device memory for fingerprint data")
    return max(1, -(-db_bytes // usable))
