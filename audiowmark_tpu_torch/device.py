"""The device the port runs on.

The port is written for one CUDA card.  `resolve(None)` is that card and
raises when CUDA is absent; the CPU is used only when a caller names it
(`resolve("cpu")`), as the CPU tests do.  There is no fallback from one to
the other.  Matmul precision stays at PyTorch's default, "highest", so no
float32 product runs in TF32.
"""

from __future__ import annotations

from typing import Optional, Union

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
