"""Top-level watermark retrieval (`get`/`cmp`): chunk loop, result merging
and reporting.

Port of audiowmark_tpu/models/getter.py (reference: src/wmget.cc:886-1013):
input at any sample rate and of any length, in 30-minute chunks resampled
to 44.1 kHz, loaded, searched and decoded one after another (no prefetch
thread, no multi-chunk group search).  Speed detection raises: it is not
ported yet.
"""

from __future__ import annotations

from typing import List

from audiowmark_tpu.crypto.keys import Key
from audiowmark_tpu.io.streams import StreamError
from audiowmark_tpu.io.wavdata import WavData
from audiowmark_tpu.params import Params
from audiowmark_tpu.utils.log import error

from ..device import DeviceLike, resolve
from .chunkloader import WavChunkLoader
from .common import parse_payload
from .decoder import BlockDecoder, ClipDecoder, _DecodeJobs
from .resultset import ResultSet


def _decode(result_set: ResultSet, key_list: List[Key], wav_data: WavData,
            first_chunk: bool, device):
    """Block decode of the chunk (and clip decode of the first), with ONE
    batched trellis launch for all of their decodes."""
    jobs = _DecodeJobs(device)
    block_decoder = BlockDecoder(1, device)
    block_decoder.run(key_list, wav_data, result_set, jobs)
    if first_chunk:
        ClipDecoder(1, device).run(key_list, wav_data, result_set, jobs)
    jobs.flush()
    result_set.debug_sync = block_decoder.debug_sync()


def report(result_set: ResultSet, time_length: int, orig_bits) -> int:
    if Params.json_output:
        result_set.print_json(time_length, Params.json_output)
    if Params.json_output != "-":
        result_set.print()
    if len(orig_bits):
        match_count = result_set.print_match_count(list(orig_bits))
        if result_set.debug_sync:
            print(result_set.debug_sync, end="")
        if Params.expect_matches >= 0:
            print("expect_matches %d" % Params.expect_matches)
            if match_count != Params.expect_matches:
                return 1
        else:
            if not match_count:
                return 1
    return 0


def get_watermark(key_list: List[Key], infile: str, orig_pattern: str,
                  device: DeviceLike = None) -> int:
    """`audiowmark get` (orig_pattern "") or `cmp` (the expected hex
    message) on `infile`, on `device` (default: the CUDA card); prints the
    reference's report and returns its exit code."""
    dev = resolve(device)
    if Params.detect_speed or Params.detect_speed_patient \
            or Params.try_speed > 0:
        raise NotImplementedError(
            "audiowmark_tpu_torch: speed detection is not ported yet "
            "(ROADMAP Queue 1: speed detection)")
    result_set = ResultSet()

    orig_bitvec = []
    if orig_pattern:
        parsed = parse_payload(orig_pattern)
        if parsed is None:
            return 1
        orig_bitvec = list(parsed)

    first_chunk = True
    loader = WavChunkLoader(infile, dev)
    try:
        while True:
            try:
                loader.load_next_chunk()
            except (StreamError, OSError) as e:
                error("audiowmark: error loading %s: %s\n" % (infile, e))
                return 1
            if loader.done():
                break
            wav_data = loader.wav_data()
            chunk_result_set = ResultSet()
            _decode(chunk_result_set, key_list,
                    wav_data.with_samples(wav_data.samples), first_chunk, dev)
            chunk_result_set.apply_time_offset(loader.time_offset())
            result_set.merge(chunk_result_set)
            first_chunk = False
    finally:
        loader.close()

    result_set.sort(key_list)
    time_length = int(round(loader.length()))
    return report(result_set, time_length, orig_bitvec)
