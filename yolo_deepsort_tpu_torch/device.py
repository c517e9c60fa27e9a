"""Which device an entry point runs on.

Every entry point of the port takes ``device=None`` and runs on the CUDA
card then; the CPU is taken only when the caller asks for it
(``device="cpu"``, or the reference facades' ``use_cuda=False``). Asking,
by default or by name, for a card that is not there raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None, use_cuda: bool = True) -> torch.device:
    """``device`` when given, else ``cuda`` unless ``use_cuda`` is False. A
    CUDA device that does not exist raises."""
    dev = torch.device(device if device is not None
                       else ("cuda" if use_cuda else "cpu"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} was asked for, but no CUDA device "
                           "is available (pass device=\"cpu\" to run on the "
                           "CPU)")
    return dev
