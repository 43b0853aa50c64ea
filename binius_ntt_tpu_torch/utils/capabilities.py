"""Device preflight: the port's counterpart of check_gpu_capabilities.

The CUDA kernels of this package are built for ``sm_90a`` (Hopper) only, so
the gate asks for a CUDA device of compute capability (9, 0) and raises
otherwise.  It never falls back to the CPU.

``default_device`` is what every entry point of the port calls for
``device=None``: the first CUDA device, or a RuntimeError that asks for
``device="cpu"`` where there is none.  Nothing picks the CPU silently.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["DeviceCapabilities", "check_capabilities", "default_device",
           "REQUIRED_CAPABILITY"]

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


def default_device(device=None) -> torch.device:
    """``device`` as a torch.device; for None, ``cuda:0``.  Raises
    RuntimeError for None where there is no CUDA device: the CPU runs the
    plain versions only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device=\"cpu\" to run the plain "
                           "versions on the CPU")
    return torch.device("cuda", 0)
