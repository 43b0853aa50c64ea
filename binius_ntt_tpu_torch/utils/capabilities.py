"""Device preflight: the port's counterpart of check_gpu_capabilities.

The CUDA kernels of this package are built for ``sm_90a`` (Hopper) only, so
the gate asks for a CUDA device of compute capability (9, 0) and raises
otherwise.  It never falls back to the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["DeviceCapabilities", "check_capabilities", "REQUIRED_CAPABILITY"]

REQUIRED_CAPABILITY = (9, 0)


@dataclass
class DeviceCapabilities:
    platform: str
    device_kind: str
    num_devices: int
    memory_bytes: int
    capability: tuple[int, int]


def check_capabilities() -> DeviceCapabilities:
    """Raise RuntimeError unless the current CUDA device has capability
    (9, 0); return its facts otherwise."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need an "
                           "sm_90 (Hopper) GPU")
    device = torch.cuda.current_device()
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"device {device} has compute capability {cap}; the kernels "
            f"are built for sm_90a and need {REQUIRED_CAPABILITY}")
    props = torch.cuda.get_device_properties(device)
    return DeviceCapabilities(
        platform="gpu",
        device_kind=torch.cuda.get_device_name(device),
        num_devices=torch.cuda.device_count(),
        memory_bytes=props.total_memory,
        capability=tuple(cap),
    )
