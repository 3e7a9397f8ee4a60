"""The device the port runs on.

The port is written for one CUDA card.  `resolve(None)` is that card and
raises when CUDA is absent; the CPU is used only when a caller names it
(`resolve("cpu")`), as the CPU tests do.  There is no fallback from one to
the other.  Matmul precision stays at PyTorch's default, "highest", so no
float32 product runs in TF32.
"""

from __future__ import annotations

import os
from typing import List, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "audiowmark_tpu_torch needs a CUDA device; pass device='cpu' "
            "(the command line: set AUDIOWMARK_TORCH_DEVICE=cpu) to run "
            "the plain PyTorch path on the CPU")
    return dev


def card_count(device: DeviceLike = None) -> int:
    """Devices that independent shares of one call split over: every CUDA
    card when `device` is one, 1 for a CPU device; AUDIOWMARK_MULTICHIP=0
    gives 1."""
    if os.environ.get("AUDIOWMARK_MULTICHIP", "1") in ("0", "false"):
        return 1
    if resolve(device).type != "cuda":
        return 1
    return torch.cuda.device_count()


def spread(device: DeviceLike, n: int) -> List[torch.device]:
    """n devices for n shares: the cards in turn, or `device` itself where
    it is not a card.  More shares than devices are logical shards: they
    run one after another on one device and give the same values."""
    dev = resolve(device)
    if dev.type != "cuda":
        return [dev] * n
    have = torch.cuda.device_count()
    return [torch.device("cuda", i % have) for i in range(n)]
