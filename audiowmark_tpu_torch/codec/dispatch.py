"""Payload codec dispatch: conv code (128-bit) vs short block codes.

Port of audiowmark_tpu/codec/dispatch.py (reference: src/shortcode.cc:117-133),
switching on Params.payload_short.
"""

from __future__ import annotations

import numpy as np

from ..params import Params

from ..device import DeviceLike
from .convcode import (ConvBlockType, conv_code_size, conv_decode_soft,
                       conv_decode_soft_batch, conv_encode)
from .shortcode import (short_code_size, short_decode_blk, short_decode_soft,
                        short_encode)


def code_encode(block_type: ConvBlockType, in_bits) -> np.ndarray:
    if Params.payload_short:
        return short_encode(block_type, in_bits)
    return conv_encode(block_type, in_bits)


def code_size(block_type: ConvBlockType, msg_size: int) -> int:
    if Params.payload_short:
        return short_code_size(block_type, msg_size)
    return conv_code_size(block_type, msg_size)


def code_decode_soft(block_type: ConvBlockType, coded_bits,
                     return_error: bool = False, device: DeviceLike = None):
    """Soft decode of one coded row with the payload's code: the bits
    (empty where a short code finds no codeword), and the error where
    `return_error` asks for it."""
    if Params.payload_short:
        return short_decode_soft(block_type, coded_bits, return_error, device)
    return conv_decode_soft(block_type, coded_bits, return_error, device)


def code_decode_soft_batch(block_type: ConvBlockType, coded_batch,
                           device: DeviceLike = None):
    """Batched soft decode: (B, n_coded) -> list of (bits, error).

    Short-payload mode runs the Viterbi stage batched and the exhaustive
    codeword match per row (an empty bits array marks a detection failure).
    """
    inner, errs = conv_decode_soft_batch(block_type, coded_batch, device)
    out = []
    for i in range(inner.shape[0]):
        bits = inner[i]
        if Params.payload_short:
            bits = short_decode_blk(bits)
        out.append((bits, float(errs[i])))
    return out
