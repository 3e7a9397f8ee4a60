"""Viterbi add-compare-select trellis with traceback: kernel K1 and its
plain PyTorch version.

The order-15 code has 32768 states; each step computes

    new[s] = min(old[s >> 1], old[(s >> 1) + 2^14]) + bm[t, s]

with the high predecessor winning only when strictly smaller, from a
metric of 0 at state 0 and 1e9 elsewhere.  `viterbi_acs` takes branch
metrics (B, steps, 32768) f32 and returns the bit-packed decisions
(B, steps, 512) int32 (bit k of word w is the decision of predecessor pair
32w + k, which successors 2p and 2p + 1 share), the final metrics
(B, 32768) f32 and the bits traced back from state 0, (B, steps) int32.
`unpack_decisions` gives the JAX package's (B, steps, 32768) int8 form.

On a CUDA tensor it launches csrc/viterbi_acs.cu (built with nvcc at first
use; one thread-block cluster per row) and counts the launch in LAUNCHES;
on a CPU tensor it runs `viterbi_acs_plain`, the lax.scan form of
audiowmark_tpu's codec/convcode.py written in torch.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from .. import cuda_build

ORDER = 15
STATE_COUNT = 1 << ORDER
PAIRS = STATE_COUNT // 2
WORDS = PAIRS // 32            # decision words per step and row
CLUSTER_SIZES = (2, 4, 8)
# the kernel counts bm tiles (up to 4 per step) and grid blocks (up to 8
# per row) in 32-bit ints
MAX_STEPS = (2**31 - 1) // 4
MAX_BATCH = (2**31 - 1) // 8
_BIG = 1e9
_ERRORS = {-1: "no cluster of %d CTAs fits on the card",
           -3: "%d is not a supported cluster size",
           -4: "bm's TMA descriptors could not be encoded (cluster %d)",
           -5: "the device index is past the kernel's table (cluster %d)"}

# launches of the CUDA kernel by viterbi_acs since the last reset, in all
# and by card index (chip_smoke.py reads them to show that a run went
# through the kernel, and on which cards)
LAUNCHES = 0
LAUNCHES_BY_CARD: Counter = Counter()


def pack_decisions(d: torch.Tensor) -> torch.Tensor:
    """(..., 16384) bool decisions of the predecessor pairs -> (..., 512)
    int32 words, bit k of word w for pair 32w + k."""
    shifts = torch.arange(32, dtype=torch.int64, device=d.device)
    words = (d.reshape(*d.shape[:-1], WORDS, 32).to(torch.int64)
             << shifts).sum(dim=-1)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def unpack_decisions(dec_bits: torch.Tensor) -> torch.Tensor:
    """(B, steps, 512) int32 packed decisions -> (B, steps, 32768) int8,
    one per state, as the JAX package's trellis gives them."""
    shifts = torch.arange(32, dtype=torch.int32, device=dec_bits.device)
    d = (dec_bits.unsqueeze(-1) >> shifts) & 1
    return d.reshape(*dec_bits.shape[:-1], PAIRS).repeat_interleave(
        2, dim=-1).to(torch.int8)


def viterbi_acs_plain(bm: torch.Tensor):
    """Plain PyTorch trellis: same outputs as the kernel, bit for bit."""
    B, steps, S = bm.shape
    half = S // 2
    metric = torch.full((B, S), _BIG, dtype=torch.float32, device=bm.device)
    metric[:, 0] = 0.0
    dec = torch.empty((B, steps, WORDS), dtype=torch.int32, device=bm.device)
    for t in range(steps):
        lo = metric[:, :half]
        hi = metric[:, half:]
        d = hi < lo                     # strict: ties keep the low state
        best = torch.where(d, hi, lo)
        metric = best.repeat_interleave(2, dim=1) + bm[:, t]
        dec[:, t] = pack_decisions(d)
    return dec, metric, _traceback(dec)


def _traceback(dec_bits: torch.Tensor) -> torch.Tensor:
    B, steps, _ = dec_bits.shape
    rows = torch.arange(B, device=dec_bits.device)
    state = torch.zeros(B, dtype=torch.int64, device=dec_bits.device)
    bits = torch.empty((B, steps), dtype=torch.int32, device=dec_bits.device)
    for t in range(steps - 1, -1, -1):
        bits[:, t] = (state & 1).to(torch.int32)
        pair = state >> 1
        word = dec_bits[rows, t, pair >> 5].to(torch.int64)
        d = (word >> (pair & 31)) & 1
        state = pair | (d << (ORDER - 1))
    return bits


def cluster_size(batch: int, sms: int) -> int:
    """CTAs per trellis row: the larger of 8 and 4 for which batch × C
    still fits on the card's `sms` SMs at once, else 2 (the rows then run
    in waves)."""
    for c in (8, 4):
        if batch * c <= sms:
            return c
    return 2


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("viterbi_acs")
    lib.viterbi_acs_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int)]
    lib.viterbi_acs_launch.restype = ctypes.c_int
    return lib


def viterbi_acs(bm: torch.Tensor):
    """(packed decisions, final metrics, bits) for branch metrics `bm`;
    on the card with `cluster_size` CTAs per row."""
    global LAUNCHES
    if bm.dim() != 3 or bm.shape[2] != STATE_COUNT:
        raise ValueError("bm must be (B, steps, %d), got %s"
                         % (STATE_COUNT, tuple(bm.shape)))
    if bm.dtype != torch.float32:
        raise TypeError("bm must be float32, got %s" % bm.dtype)
    if bm.device.type == "cpu":
        return viterbi_acs_plain(bm)
    if bm.device.type != "cuda":
        raise ValueError("viterbi_acs runs on cuda or cpu, not %s"
                         % bm.device)
    B, steps, _ = bm.shape
    if B == 0 or steps == 0:
        raise ValueError("bm must hold at least one row and one step")
    if steps > MAX_STEPS:
        raise ValueError("bm has %d steps; the kernel takes at most "
                         "MAX_STEPS = %d" % (steps, MAX_STEPS))
    if B > MAX_BATCH:
        raise ValueError("bm has %d rows; the kernel takes at most "
                         "MAX_BATCH = %d" % (B, MAX_BATCH))
    if not bm.is_contiguous() or bm.data_ptr() % 16:
        raise ValueError("bm must be contiguous and 16-byte aligned (the "
                         "kernel loads it with cp.async.bulk)")
    outs = outputs(bm)
    launch(bm, *outs, cluster_size(B, torch.cuda.get_device_properties(
        bm.device).multi_processor_count))
    LAUNCHES += 1
    LAUNCHES_BY_CARD[bm.device.index] += 1
    return outs


def bound_ms(batch: int, steps: int) -> float:
    """The least time K1's bytes take on an H100 SXM (3.35 TB/s, NVIDIA's
    data sheet): bm read once, the packed decisions, metrics and bits
    written once."""
    per_row = (steps * STATE_COUNT * 4 + steps * WORDS * 4
               + STATE_COUNT * 4 + steps * 4)
    return batch * per_row / 3.35e12 * 1e3


def outputs(bm: torch.Tensor):
    """Empty (packed decisions, metrics, bits) for branch metrics `bm`."""
    B, steps, _ = bm.shape
    return (torch.empty((B, steps, WORDS), dtype=torch.int32,
                        device=bm.device),
            torch.empty((B, STATE_COUNT), dtype=torch.float32,
                        device=bm.device),
            torch.empty((B, steps), dtype=torch.int32, device=bm.device))


def launch(bm, dec, metrics, bits, cluster: int) -> int:
    """One launch of the kernel with `cluster` CTAs per row on the current
    stream, into `outputs(bm)`, with the checks of `viterbi_acs` already
    made; not counted in LAUNCHES.  Returns how many clusters of that size
    the card holds at once."""
    if cluster not in CLUSTER_SIZES:
        raise ValueError("cluster must be one of %s, not %r"
                         % (CLUSTER_SIZES, cluster))
    lib = _library()
    active = ctypes.c_int(0)
    with torch.cuda.device(bm.device):
        stream = torch.cuda.current_stream(bm.device).cuda_stream
        err = lib.viterbi_acs_launch(
            bm.data_ptr(), dec.data_ptr(), metrics.data_ptr(),
            bits.data_ptr(), bm.shape[0], bm.shape[1], cluster, stream,
            ctypes.byref(active))
    if err != 0:
        what = (_ERRORS[err] % cluster if err in _ERRORS
                else "CUDA error %d" % err)
        raise RuntimeError("viterbi_acs launch failed: " + what)
    return active.value
