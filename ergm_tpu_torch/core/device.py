"""Where the port's entry points run: the card, unless the caller asks
for another device (the CPU tests pass ``device="cpu"``)."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device that is not there
    is refused instead of landing quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} was asked for, but torch.cuda.is_available() is "
                           f"False; pass device='cpu' to run on the CPU")
    return dev


def on_card(x: torch.Tensor) -> bool:
    """Whether ``auto`` routes take the kernels for ``x``: a CUDA tensor.
    The routes read it here, so that a test can stand in a card."""
    return x.is_cuda
