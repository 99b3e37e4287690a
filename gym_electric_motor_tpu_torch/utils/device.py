"""The device an entry point of the package runs on."""

from __future__ import annotations

import torch


def resolve_device(device):
    """``cuda`` unless the caller names a device.  Without a GPU and without
    an explicit device this raises; it never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run this package on the CPU")
    return torch.device("cuda")
