"""Device resolution for the port's public entry points.

Every public function takes ``device``, ``"cuda"`` unless the caller asks
for the CPU; nothing picks one on the caller's behalf. ``"cuda"`` on a
machine without a usable GPU raises instead of carrying on on the CPU, so a
measurement can never silently run on the wrong device.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """Validate *device* ("cpu", "cuda", "cuda:N" or a torch.device)."""
    if device is None:
        raise TypeError("device is required: pass device='cpu' or "
                        "device='cuda'")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={str(device)!r} but torch sees no "
                               "CUDA GPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device={str(device)!r} but only "
                               f"{torch.cuda.device_count()} GPU(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r} "
                         "(the port runs on 'cpu' or 'cuda')")
    return dev
