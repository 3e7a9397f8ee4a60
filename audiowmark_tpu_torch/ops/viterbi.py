"""Viterbi add-compare-select trellis with traceback: kernel K1 and its
plain PyTorch version.

The order-15 code has 32768 states; each step computes

    new[s] = min(old[s >> 1], old[(s >> 1) + 2^14]) + bm[t, s]

with the high predecessor winning only when strictly smaller, from a
metric of 0 at state 0 and 1e9 elsewhere.  `viterbi_acs` takes branch
metrics (B, steps, 32768) f32 and returns the decisions (B, steps, 32768)
int8, the final metrics (B, 32768) f32 and the bits traced back from
state 0, (B, steps) int32.

On a CUDA tensor it launches csrc/viterbi_acs.cu (built with nvcc at first
use) and counts the launch in LAUNCHES; on a CPU tensor it runs
`viterbi_acs_plain`, the lax.scan form of audiowmark_tpu's
codec/convcode.py written in torch.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cuda_build

ORDER = 15
STATE_COUNT = 1 << ORDER
_BIG = 1e9

# launches of the CUDA kernel since the last reset (chip_smoke.py reads it
# to show that a run went through the kernel)
LAUNCHES = 0


def viterbi_acs_plain(bm: torch.Tensor):
    """Plain PyTorch trellis: same outputs as the kernel, bit for bit."""
    B, steps, S = bm.shape
    half = S // 2
    metric = torch.full((B, S), _BIG, dtype=torch.float32, device=bm.device)
    metric[:, 0] = 0.0
    dec = torch.empty((B, steps, S), dtype=torch.int8, device=bm.device)
    for t in range(steps):
        lo = metric[:, :half]
        hi = metric[:, half:]
        d = hi < lo                     # strict: ties keep the low state
        best = torch.where(d, hi, lo)
        metric = best.repeat_interleave(2, dim=1) + bm[:, t]
        dec[:, t] = d.repeat_interleave(2, dim=1)
    return dec, metric, _traceback(dec)


def _traceback(dec: torch.Tensor) -> torch.Tensor:
    B, steps, _ = dec.shape
    rows = torch.arange(B, device=dec.device)
    state = torch.zeros(B, dtype=torch.int64, device=dec.device)
    bits = torch.empty((B, steps), dtype=torch.int32, device=dec.device)
    for t in range(steps - 1, -1, -1):
        bits[:, t] = (state & 1).to(torch.int32)
        d = dec[rows, t, state].to(torch.int64)
        state = (state >> 1) | (d << (ORDER - 1))
    return bits


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("viterbi_acs")
    lib.viterbi_acs_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.viterbi_acs_launch.restype = ctypes.c_int
    return lib


def viterbi_acs(bm: torch.Tensor):
    """(decisions, final metrics, bits) for branch metrics `bm`."""
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
    if not bm.is_contiguous() or bm.data_ptr() % 8:
        raise ValueError("bm must be contiguous and 8-byte aligned (the "
                         "kernel reads float2)")
    B, steps, _ = bm.shape
    if B == 0 or steps == 0:
        raise ValueError("bm must hold at least one row and one step")
    dec = torch.empty((B, steps, STATE_COUNT), dtype=torch.int8,
                      device=bm.device)
    metrics = torch.empty((B, STATE_COUNT), dtype=torch.float32,
                          device=bm.device)
    bits = torch.empty((B, steps), dtype=torch.int32, device=bm.device)
    lib = _library()
    with torch.cuda.device(bm.device):
        stream = torch.cuda.current_stream(bm.device).cuda_stream
        err = lib.viterbi_acs_launch(
            bm.data_ptr(), dec.data_ptr(), metrics.data_ptr(),
            bits.data_ptr(), B, steps, stream)
    if err != 0:
        raise RuntimeError("viterbi_acs launch failed: CUDA error %d" % err)
    LAUNCHES += 1
    return dec, metrics, bits
