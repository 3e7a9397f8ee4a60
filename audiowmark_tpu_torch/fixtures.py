"""Deterministic test inputs, without jax.

`gen_noise` is a copy of audiowmark_tpu/cli.py's test_gen_noise (the CLI's
`test-gen-noise`): stereo noise in [-1, 1) from the key's AES-CTR keystream
on the data_up_down stream, written as a wav file.  The same key, length and
rate give the same bytes from either package.

`long_noise` is seeded uniform stereo noise for long fixtures, where the
AES-CTR keystream in numpy would take minutes.

`raw_format` and `write_wav` make the inputs of the stream cases: a raw
PCM format by name, and a WAV file in any sample format.

`acs_check_metrics` gives branch metrics that hold the Viterbi trellis's
hard cases, for checking kernel K1 against its plain version, and
`acs_equal` is that check.
"""

from __future__ import annotations

import numpy as np
import torch

from .crypto import aes
from .crypto.keys import Key
from .crypto.prng import Random, Stream
from .io import wavfile
from .io.converters import RawConverter
from .io.wavdata import WavData
from .params import Encoding, RawFormat

from .codec.convcode import (ConvBlockType, _state_output_table,
                             batch_branch_metrics, conv_encode)
from .models.decoder import normalize_soft_bits
from .ops.viterbi import ORDER, STATE_COUNT


def raw_format(encoding: str, bits: int, endian: str = "little",
               rate: int = 44100) -> RawFormat:
    """The stereo RawFormat of `encoding` ("signed", "unsigned" or
    "float"), `bits` and `endian` ("little" or "big")."""
    fmt = RawFormat()
    fmt.set_encoding({"signed": Encoding.SIGNED, "unsigned":
                      Encoding.UNSIGNED, "float": Encoding.FLOAT}[encoding])
    fmt.set_bit_depth(bits)
    fmt.set_endian(RawFormat.Endian.BIG if endian == "big"
                   else RawFormat.Endian.LITTLE)
    fmt.set_sample_rate(rate)
    return fmt


def write_wav(path: str, samples: np.ndarray, bits: int,
              encoding: Encoding, rate: int = 44100) -> None:
    """Stereo `samples` as a WAV file of `bits` and `encoding`, 8-bit
    unsigned included (io/wavfile.py's writer writes 16 bits and up)."""
    with open(path, "wb") as f:
        if bits == 8:
            data = RawConverter(raw_format("unsigned", 8)).to_raw(samples)
            f.write(wavfile.build_header(2, rate, 8, Encoding.UNSIGNED,
                                         len(data), False) + data)
            return
        w = wavfile.WavFileWriter(f, 2, rate, bits, encoding)
        w.write_frames(samples)
        w.close()


def acs_check_metrics(seed: int, batch: int, steps: int,
                      device) -> torch.Tensor:
    """(batch, steps, STATE_COUNT) f32 branch metrics on `device`, made
    from a numpy seed: one row of a clean codeword per block type (integer
    metrics, so many paths tie exactly), one all-NaN row (what
    normalize_soft_bits gives for silence), and uniform-random rows for the
    rest.  Where steps <= ORDER (no codeword fits) or batch < 4, every row
    is uniform-random."""
    rng = np.random.RandomState(seed)
    if steps <= ORDER or batch < 4:
        return torch.from_numpy(rng.rand(batch, steps, STATE_COUNT)
                                .astype(np.float32)).to(device)
    rows = []
    for bt in ConvBlockType:
        coded = conv_encode(bt, rng.randint(0, 2, steps - ORDER)) \
            .astype(np.float32)
        table = torch.from_numpy(_state_output_table(bt))
        rows.append(batch_branch_metrics(torch.from_numpy(coded[None]),
                                         table)[0])
    n_coded = steps * _state_output_table(ConvBlockType.a).shape[1]
    nan_row = normalize_soft_bits(np.zeros(n_coded, np.float32))
    rows.append(batch_branch_metrics(
        torch.from_numpy(nan_row[None]),
        torch.from_numpy(_state_output_table(ConvBlockType.a)))[0])
    rand = rng.rand(batch - len(rows), steps, STATE_COUNT).astype(np.float32)
    bm = torch.cat([torch.stack(rows), torch.from_numpy(rand)])
    return bm.contiguous().to(device)


def acs_equal(got, want) -> bool:
    """Two (decisions, metrics, bits) of the trellis are equal bit for bit,
    NaN metrics equal to NaN."""
    return (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
            and torch.equal(torch.isnan(got[1]), torch.isnan(want[1]))
            and torch.equal(torch.nan_to_num(got[1]),
                            torch.nan_to_num(want[1])))


def gen_noise(key: Key, out_file: str, seconds: float, rate: int,
              bits: int = 16):
    channels = 2
    n = int(rate * seconds) * channels
    rk = aes.expand_key(key.aes_key())
    rng = Random(key, 0, Stream.data_up_down)
    u = aes.ctr_keystream_u64(rk, rng._iv, 0, -(-n // 2))[:n]
    d = u.astype(np.float64) / np.float64(2.0 ** 64)
    noise = (d * 2 - 1).astype(np.float32)
    WavData(noise, channels, rate, bits).save(out_file)


def long_noise(seed: int, out_file: str, seconds: float, rate: int):
    """16-bit stereo noise, uniform in [-1, 1), from
    np.random.default_rng(seed), written as a wav file."""
    n = int(rate * seconds) * 2
    rng = np.random.default_rng(seed)
    noise = rng.random(n, dtype=np.float32) * np.float32(2) - np.float32(1)
    WavData(noise, 2, rate, 16).save(out_file)
