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
    """`device` as a torch.device; None means the CUDA card.  A card is
    always named with its index ("cuda" is the calling thread's current
    card), so that caches keyed by device see one device under one key,
    and a host thread, whose current card is 0 whatever the caller set,
    works on the card the caller meant."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "audiowmark_tpu_torch needs a CUDA device; pass device='cpu' "
            "(the command line: set AUDIOWMARK_TORCH_DEVICE=cpu) to run "
            "the plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
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


def _set_up_vector_math() -> None:
    """Make the process's first call into MKL's vector math on one thread.

    On the CPU, torch.log, exp, sqrt, sin, log10 and their kin over 2048
    or more float32 elements split over the OpenMP threads and call MKL's
    vector math library, which sets itself up at its first call.  When that
    first call runs on several threads at once, the calling thread's share
    can come out of another code path: in 3-13 % of fresh processes most of
    the main thread's share of the first torch.log differs from every later
    call on the same input (~28700 of 32832 elements, not correctly
    rounded), so the same embed gave two results in one process.  One call
    on one thread first (one element: below the split) sets the library up
    for every function, and every call after it gives the same bits
    (tests/test_torch_mesh.py::test_first_embed_of_a_process_equals_the_next).
    """
    torch.log(torch.ones(1))


_set_up_vector_math()
