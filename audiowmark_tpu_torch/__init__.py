"""audiowmark_tpu_torch — the PyTorch/CUDA port of audiowmark_tpu.

The CLI's `add` and `get`/`cmp` at any sample rate and any length, replay
speed detection included, in PyTorch on one CUDA card, with the Viterbi
trellis as a hand-written CUDA kernel (csrc/viterbi_acs.cu), and the
command line itself: `python -m audiowmark_tpu_torch` (cli.py).  The JAX
package `audiowmark_tpu` stays the reference; the port imports nothing of
it and no jax.  It keeps its own copies of the reference's host modules
(`params`, `crypto`, `io`, `utils`): its settings live in
`audiowmark_tpu_torch.params.Params`.

    from audiowmark_tpu_torch import add_watermark, get_watermark
    from audiowmark_tpu_torch.crypto.keys import Key
    add_watermark(Key(), "in.wav", "out.wav", "0123456789abcdef0011223344556677")
    get_watermark([Key()], "out.wav", "0123456789abcdef0011223344556677")
"""

__version__ = "0.1.0"

from .models.embedder import add_watermark  # noqa: F401
from .models.getter import get_watermark  # noqa: F401
