"""Resolve the `device` argument of the port's entry points.

Counterpart of `soda_tpu/utils/backend_probe.py`.  The entry points run on
the card ("cuda", their default, or "cuda:N"), which raises `NoCudaDevice`
without a card -- it never falls back to the CPU; "cpu" runs the plain
PyTorch path.
"""

from __future__ import annotations

import torch


class NoCudaDevice(RuntimeError):
    """A CUDA device was asked for on a machine without one."""


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCudaDevice(
                f"device {str(device)!r} requested but torch sees no CUDA "
                f"device (torch {torch.__version__}, built for CUDA "
                f"{torch.version.cuda})")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cpu' or 'cuda'")
    return dev
