"""Rate-1/6 (A/B) / rate-1/12 (AB), order-15 convolutional code.

Port of audiowmark_tpu/codec/convcode.py.  The encoder and the generator
tables are host numpy, copied as they are.  The soft decoder computes all
branch metrics with one matmul

    bm[b, t, s] = sum_p c[b,t,p]^2 - 2 c[b,t,:] . S[s,:] + sum_p S[s,p]

on the device and runs the add-compare-select trellis and the traceback in
ops/viterbi.py (kernel K1 on CUDA).  Rows of every block type share one
trellis launch: a/b (rate 6) and ab (rate 12) codes of one payload have the
same number of steps.  Ties go to the lower-numbered predecessor, as in the
reference.
"""

from __future__ import annotations

from enum import Enum
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve
from ..ops.viterbi import ORDER, STATE_COUNT, viterbi_acs
from ..utils import prof


class ConvBlockType(Enum):
    a = 0
    b = 1
    ab = 2


AB_GENERATORS = (
    0o66561, 0o75211, 0o71545, 0o54435, 0o63635, 0o52475,
    0o63543, 0o75307, 0o52547, 0o45627, 0o67657, 0o51757,
)
AB_RATE = len(AB_GENERATORS)
STATE_MASK = STATE_COUNT - 1


def get_block_type_generators(block_type: ConvBlockType) -> Tuple[int, ...]:
    if block_type == ConvBlockType.a:
        return AB_GENERATORS[0::2]
    if block_type == ConvBlockType.b:
        return AB_GENERATORS[1::2]
    return AB_GENERATORS


def conv_code_size(block_type: ConvBlockType, msg_size: int) -> int:
    if block_type in (ConvBlockType.a, ConvBlockType.b):
        return (msg_size + ORDER) * AB_RATE // 2
    return (msg_size + ORDER) * AB_RATE


def conv_encode(block_type: ConvBlockType, in_bits) -> np.ndarray:
    """Shift-register encoder (vectorized): out[t,p] = XOR_k poly_k bits[t-k]."""
    generators = get_block_type_generators(block_type)
    bits = np.concatenate([np.asarray(in_bits, dtype=np.uint8),
                           np.zeros(ORDER, dtype=np.uint8)])
    n = len(bits)
    out = np.zeros((n, len(generators)), dtype=np.uint8)
    padded = np.concatenate([np.zeros(ORDER - 1, dtype=np.uint8), bits])
    for p, poly in enumerate(generators):
        acc = np.zeros(n, dtype=np.uint8)
        for k in range(ORDER):
            if poly & (1 << k):
                # reg bit k at step t is input bit t-k
                acc ^= padded[ORDER - 1 - k: ORDER - 1 - k + n]
        out[:, p] = acc
    return out.reshape(-1).astype(np.int32)


@lru_cache(maxsize=None)
def _state_output_table(block_type: ConvBlockType) -> np.ndarray:
    """S[state, p] = parity(state & poly) as float32 (STATE_COUNT, rate)."""
    generators = get_block_type_generators(block_type)
    states = np.arange(STATE_COUNT, dtype=np.uint32)
    cols = []
    for poly in generators:
        v = states & np.uint32(poly)
        # parity via popcount folding
        v ^= v >> 8
        v ^= v >> 4
        v ^= v >> 2
        v ^= v >> 1
        cols.append((v & 1).astype(np.float32))
    return np.stack(cols, axis=1)


def batch_branch_metrics(codeds: torch.Tensor, s_table: torch.Tensor,
                         out: torch.Tensor = None) -> torch.Tensor:
    """bm (B, steps, STATE_COUNT) for coded rows (B, steps*rate) against
    one parity table (STATE_COUNT, rate), via one matmul, written into
    `out` where it is given (a contiguous tensor of that shape).  In place,
    -2·M + c_sq + s_sum rounds as c_sq - 2·M + s_sum does: the factor 2 is
    exact and a - b is a + (-b).  c_sq sums the squares left to right, as
    the JAX package's jnp.sum does on the CPU: torch.sum rounds in another
    order, and a last-bit difference in bm flips the trellis's near-ties
    on noise."""
    rate = s_table.shape[1]
    c = codeds.reshape(codeds.shape[0], -1, rate)
    sq = c * c
    c_sq = sq[:, :, :1]                                       # (B, steps, 1)
    for p in range(1, rate):
        c_sq = c_sq + sq[:, :, p:p + 1]
    s_sum = torch.sum(s_table, dim=1)[None, None, :]          # (1, 1, states)
    if out is None:
        out = torch.empty((c.shape[0], c.shape[1], s_table.shape[0]),
                          dtype=c.dtype, device=c.device)
    torch.matmul(c, s_table.T, out=out)
    return out.mul_(-2.0).add_(c_sq).add_(s_sum)


class ViterbiDecoder(nn.Module):
    """Soft-decision Viterbi decoder holding the parity tables of the three
    block types on its device."""

    def __init__(self):
        super().__init__()
        for bt in ConvBlockType:
            self.register_buffer(
                "table_" + bt.name,
                torch.from_numpy(_state_output_table(bt)))

    def table(self, block_type: ConvBlockType) -> torch.Tensor:
        return getattr(self, "table_" + block_type.name)

    def forward(self, groups: List[Tuple[ConvBlockType, torch.Tensor]]):
        """groups of (block type, coded rows (B_i, n_i) on this device) with
        equal step counts -> (bits (sum B_i, steps) int32, errors
        (sum B_i,) f32), rows in group order, through ONE trellis."""
        with prof.phase("viterbi.forward"):
            return self._forward(groups)

    def _forward(self, groups):
        _, c0 = groups[0]
        steps = c0.shape[1] // self.table(groups[0][0]).shape[1]
        bm = torch.empty((sum(c.shape[0] for _, c in groups), steps,
                          STATE_COUNT), dtype=torch.float32, device=c0.device)
        n_coded = torch.empty(bm.shape[0], dtype=torch.float32,
                              device=c0.device)
        k = 0
        for bt, c in groups:
            batch_branch_metrics(c, self.table(bt), out=bm[k:k + c.shape[0]])
            n_coded[k:k + c.shape[0]] = float(c.shape[1])
            k += c.shape[0]
        _, metrics, bits = viterbi_acs(bm)
        return bits, metrics[:, 0] / n_coded


_decoders: Dict[torch.device, ViterbiDecoder] = {}


def viterbi_decoder(device: DeviceLike = None) -> ViterbiDecoder:
    """The decoder on `device` (one per device, tables uploaded once)."""
    dev = resolve(device)
    dec = _decoders.get(dev)
    if dec is None:
        prof.count("build.viterbi_decoder")
        dec = ViterbiDecoder().to(dev)
        _decoders[dev] = dec
    return dec


def conv_decode_soft_mixed(groups, device: DeviceLike = None):
    """Mixed-type batched Viterbi decode in one trellis launch.

    groups: list of (block_type, coded (B_i, n_i)) with equal step counts.
    Returns [(bits (B_i, n_msg_i) int32, errs (B_i,) f32)] per group, as
    numpy arrays."""
    if not groups:
        return []
    steps = {np.shape(c)[1] // len(get_block_type_generators(bt))
             for bt, c in groups}
    if len(steps) != 1:
        raise ValueError("mixed decode requires equal step counts")
    dec = viterbi_decoder(device)
    dev = dec.table_a.device
    live = [(bt, torch.as_tensor(np.asarray(c, dtype=np.float32), device=dev))
            for bt, c in groups if np.shape(c)[0]]
    if live:
        bits_d, errs_d = dec(live)
        with prof.phase("viterbi.readback"):
            bits = bits_d.cpu().numpy()
            errs = errs_d.cpu().numpy()
    out = []
    k = 0
    for bt, c in groups:
        rate = len(get_block_type_generators(bt))
        n_msg = max(np.shape(c)[1] // rate - ORDER, 0)
        n = np.shape(c)[0]
        if n == 0:            # empty group: typed empty outputs
            out.append((np.zeros((0, n_msg), np.int32),
                        np.zeros(0, np.float32)))
            continue
        out.append((bits[k:k + n, :n_msg], errs[k:k + n]))
        k += n
    return out


def conv_decode_soft(block_type: ConvBlockType, coded_bits,
                     return_error: bool = False, device: DeviceLike = None):
    """Soft-decision Viterbi decode; coded_bits in [0,1] floats."""
    rate = len(get_block_type_generators(block_type))
    coded = np.asarray(coded_bits, dtype=np.float32).reshape(-1)
    if coded.size % rate:
        raise ValueError("coded length %d is not a multiple of the rate %d"
                         % (coded.size, rate))
    (bits, errs), = conv_decode_soft_mixed([(block_type, coded[None])],
                                           device)
    if return_error:
        return bits[0], float(errs[0])
    return bits[0]


def conv_decode_soft_batch(block_type: ConvBlockType, coded_batch,
                           device: DeviceLike = None):
    """Batched decode: (B, n_coded) -> ((B, n_msg) bits, (B,) errors)."""
    coded = np.asarray(coded_batch, dtype=np.float32)
    if coded.ndim != 2:
        raise ValueError("coded_batch must be (B, n_coded), got shape %s"
                         % (coded.shape,))
    return conv_decode_soft_mixed([(block_type, coded)], device)[0]


def conv_decode_hard(block_type: ConvBlockType, coded_bits,
                     device: DeviceLike = None) -> np.ndarray:
    """Viterbi decode of hard 0/1 coded bits: the soft decoder on them."""
    return conv_decode_soft(block_type, np.asarray(coded_bits, np.float32),
                            device=device)
