"""audiowmark_tpu_torch — the PyTorch/CUDA port of audiowmark_tpu.

The CLI's `add` and `get`/`cmp` at any sample rate and any length (speed
detection still raises), in PyTorch on one CUDA card, with the Viterbi
trellis as a hand-written CUDA kernel (csrc/viterbi_acs.cu).  The JAX package `audiowmark_tpu` stays the
reference; the port reuses only its jax-free host modules (params, crypto,
io, utils) and imports no jax.

    from audiowmark_tpu.crypto.keys import Key
    from audiowmark_tpu_torch import add_watermark, get_watermark
    add_watermark(Key(), "in.wav", "out.wav", "0123456789abcdef0011223344556677")
    get_watermark([Key()], "out.wav", "0123456789abcdef0011223344556677")
"""

from .models.embedder import add_watermark  # noqa: F401
from .models.getter import get_watermark  # noqa: F401
