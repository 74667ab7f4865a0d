"""Where the port's entry points put their tensors: on the card unless the
caller asks for another device."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` as a torch.device; with None, the CUDA device.

    Raises RuntimeError when no device is given and CUDA is unavailable:
    the port runs on the card unless the caller passes ``device="cpu"``,
    and never drops to the CPU on its own.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: tracer_torch builds on the card "
                           "by default; pass device='cpu' for the CPU")
    return torch.device("cuda")
