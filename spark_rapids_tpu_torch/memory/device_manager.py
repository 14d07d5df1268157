"""Device manager: the card's memory, and the arena budget sized from it.

Counterpart of ``spark_rapids_tpu/memory/device_manager.py``
(``probe_device`` :31, ``initialize_device`` :45): the card's total
memory comes from ``torch.cuda.mem_get_info`` and its name from
``get_device_properties``; the arena's budget is
``spark.rapids.memory.tpu.allocFraction`` of it (the reference's key).
Without a card the arena stays unlimited bookkeeping.
"""
from __future__ import annotations

from typing import Optional

import torch


class DeviceInfo:
    def __init__(self, device: torch.device, total_bytes: Optional[int],
                 free_bytes: Optional[int], name: str):
        self.device = device
        self.total_bytes = total_bytes
        self.free_bytes = free_bytes
        self.name = name

    def __repr__(self):
        size = (f"{self.total_bytes / (1 << 30):.1f}GiB"
                if self.total_bytes else "unknown")
        return f"DeviceInfo({self.name}, memory={size})"


def probe_device(device=None) -> DeviceInfo:
    """The card of this process (the current CUDA device), or the CPU."""
    if not torch.cuda.is_available():
        return DeviceInfo(torch.device("cpu"), None, None, "cpu")
    dev = torch.device(device if device is not None else "cuda")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    free, total = torch.cuda.mem_get_info(idx)
    name = torch.cuda.get_device_properties(idx).name
    return DeviceInfo(torch.device("cuda", idx), int(total), int(free), name)


def initialize_device(conf, device=None) -> DeviceInfo:
    """Size the arena's budget from the card's memory and the conf's
    fraction; never below what the handles already hold."""
    from spark_rapids_tpu_torch.memory.arena import device_arena
    info = probe_device(device)
    frac = conf.device_memory_fraction
    arena = device_arena()
    if info.total_bytes and 0.0 < frac <= 1.0:
        arena.budget_bytes = max(int(info.total_bytes * frac),
                                 arena.used_bytes)
    return info
