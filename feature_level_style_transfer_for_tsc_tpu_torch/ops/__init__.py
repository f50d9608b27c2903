"""Compute ops of the port: hand-written CUDA kernels and their plain versions.

One dispatch rule holds for every op here: a tensor on a CUDA device goes to
the kernel, a tensor on the CPU goes to the plain PyTorch version.  Nothing
else chooses between them (no environment knob like the JAX package's
``use_pallas()``), and a CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

import torch


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain version for device {t.device}")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must really be there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is false; "
            "pass device='cpu' (--device cpu) to run the plain PyTorch path"
        )
    return device


from .batchnorm import BNStats, batch_norm_eval  # noqa: E402,F401
from .osconv import build_os_mask, masked_os_conv  # noqa: E402,F401
