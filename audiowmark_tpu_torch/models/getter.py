"""Top-level watermark retrieval (`get`/`cmp`): chunk loop, result merging
and reporting.

Port of audiowmark_tpu/models/getter.py (reference: src/wmget.cc:886-1013):
input at any sample rate and of any length, in 30-minute chunks resampled
to 44.1 kHz.  While a chunk (or a group of chunks) is searched and decoded,
a host thread loads the next chunk and starts its copy to the card
(AUDIOWMARK_PREFETCH=0 turns that off); with several cards, chunks are
searched in groups of one per card in one batched launch
(AUDIOWMARK_MULTICHIP=0 turns that off) and then decoded one by one.  With
--detect-speed, --detect-speed-patient or --try-speed each chunk is also
resampled to the detected or given speed and decoded there, ahead of its
speed-1 decode: spans `get.speed` (the detection), `get.speed_decode` (the
decode at a speed) and, inside it, `get.speed_resample`.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

import torch

from ..crypto.keys import Key
from ..io.streams import StreamError
from ..io.wavdata import WavData
from ..ops.resample import resample_ratio
from ..params import Params
from ..utils.log import error

from ..device import DeviceLike, resolve
from .chunkloader import WavChunkLoader
from ..utils import prof
from . import syncfinder
from .common import parse_payload
from .decoder import BlockDecoder, ClipDecoder, _DecodeJobs
from .resultset import ResultSet
from .speed import detect_speed

# samples held at once by one group of chunks (~2 GB of float32)
_GROUP_BUDGET = 500_000_000


class _ChunkUpload:
    """A chunk's samples on their way to the card: copied from a pinned
    host buffer on a side stream, with an event the consumer's stream
    waits on before it reads them."""

    def __init__(self, samples, device: torch.device,
                 stream: "torch.cuda.Stream"):
        self._pinned = torch.from_numpy(samples).pin_memory()
        with torch.cuda.stream(stream):
            self._x = self._pinned.to(device, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(stream)

    def tensor(self) -> torch.Tensor:
        """The (n*C,) f32 samples on the card, ready for the current
        stream."""
        current = torch.cuda.current_stream(self._x.device)
        current.wait_event(self._event)
        self._x.record_stream(current)
        return self._x


def _decode(result_set: ResultSet, key_list: List[Key], wav_data: WavData,
            orig_bits, first_chunk: bool, device, block_sync=None,
            x: Optional[torch.Tensor] = None):
    """Block decode of the chunk (and clip decode of the first), with ONE
    batched trellis launch for all of their decodes; before it, with a
    speed option, the same for each key at its detected or given speed, on
    the chunk resampled to that speed, with a launch of its own.
    block_sync: the chunk's BLOCK search results where a group search made
    them; x: the chunk's samples where they are on the device already."""
    if Params.detect_speed or Params.detect_speed_patient \
            or Params.try_speed > 0:
        if Params.detect_speed or Params.detect_speed_patient:
            with prof.phase("get.speed"):
                speed_results = detect_speed(key_list, wav_data,
                                             print_results=bool(orig_bits),
                                             device=device)
        else:
            speed_results = [(key, Params.try_speed) for key in key_list]

        for key, speed in speed_results:
            with prof.phase("get.speed_decode"):
                with prof.phase("get.speed_resample"):
                    wav_speed = resample_ratio(
                        wav_data, speed, int(Params.mark_sample_rate * speed),
                        device)
                jobs = _DecodeJobs(device)
                BlockDecoder(speed, device).run([key], wav_speed, result_set,
                                                jobs)
                if first_chunk:
                    ClipDecoder(speed, device).run([key], wav_speed,
                                                   result_set, jobs)
                jobs.flush()

    # the clip pair search is ENQUEUED before the block search's blocking
    # read: launches are asynchronous, so the card scores the clip windows
    # while the host selects from the block results
    jobs = _DecodeJobs(device)
    clip_fin = None
    if first_chunk:
        clip_fin = ClipDecoder(1, device).launch(key_list, wav_data)
    block_decoder = BlockDecoder(1, device)
    block_decoder.run(key_list, wav_data, result_set, jobs,
                      sync_results=block_sync, x=x)
    if clip_fin is not None:
        clip_fin(result_set, jobs)
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


def _load_one(loader: WavChunkLoader):
    """Advance the loader one chunk; (wav snapshot, time_offset) or None at
    the stream's end.  The snapshot pairs the samples array with the
    offset: `load_next_chunk` replaces (never mutates) the array, so a
    snapshot stays valid while later chunks load."""
    loader.load_next_chunk()
    if loader.done():
        return None
    wav_data = loader.wav_data()
    assert wav_data.sample_rate == Params.mark_sample_rate
    return (wav_data.with_samples(wav_data.samples), loader.time_offset())


def get_watermark(key_list: List[Key], infile: str, orig_pattern: str,
                  device: DeviceLike = None) -> int:
    """`audiowmark get` (orig_pattern "") or `cmp` (the expected hex
    message) on `infile`, on `device` (default: the CUDA card); prints the
    reference's report and returns its exit code."""
    dev = resolve(device)
    result_set = ResultSet()

    orig_bitvec = []
    if orig_pattern:
        parsed = parse_payload(orig_pattern)
        if parsed is None:
            return 1
        orig_bitvec = list(parsed)

    # several cards: chunks of a long file are searched in groups (one
    # batched launch covers group_cap chunks); each chunk decodes as ever
    group_cap = syncfinder.group_device_count(dev)

    # chunk prefetch: while a group decodes, a host thread loads the next
    # chunk (file read, codec decode, resample) and starts its copy to the
    # card on a side stream.  The loader's own device work (the resampler)
    # stays on the default stream, where launches run in the order they
    # were issued whichever thread issued them, and the thread is joined
    # before the loader or its chunk is touched again.
    prefetch_on = os.environ.get("AUDIOWMARK_PREFETCH", "1") not in (
        "0", "false")
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    pending: list = []        # one result or exception from the thread
    thread = None

    def _prefetch_body():
        try:
            item = _load_one(loader)
            if item is not None and copy_stream is not None:
                item += (_ChunkUpload(item[0].samples, dev, copy_stream),)
            pending.append(item)
        except BaseException as e:   # raised again on the main thread
            pending.append(e)

    def _take_next():
        nonlocal thread
        if thread is not None:
            with prof.phase("get.load_join"):
                thread.join()
            thread = None
            item = pending.pop()
            if isinstance(item, BaseException):
                raise item
            return item
        with prof.phase("get.load"):
            return _load_one(loader)

    first_chunk = True
    loader = WavChunkLoader(infile, dev)
    end_of_stream = False
    try:
        while not end_of_stream:
            chunks = []       # [(wav snapshot, time_offset[, upload])]
            budget = _GROUP_BUDGET
            while len(chunks) < group_cap:
                try:
                    item = _take_next()
                except (StreamError, OSError) as e:
                    error("audiowmark: error loading %s: %s\n" % (infile, e))
                    return 1
                if item is None:
                    end_of_stream = True
                    break
                budget -= item[0].samples.size
                chunks.append(item)
                if budget <= 0:
                    break
            if not chunks:
                break

            if prefetch_on and not end_of_stream:
                thread = threading.Thread(target=_prefetch_body, daemon=True)
                thread.start()

            wavs = [c[0] for c in chunks]
            xs = [c[2].tensor() if len(c) > 2 else None for c in chunks]
            presearched = None
            if len(chunks) > 1:
                with prof.phase("get.search_group"):
                    presearched = syncfinder.search_block_group(
                        key_list, wavs, dev, xs)

            for i, chunk in enumerate(chunks):
                chunk_result_set = ResultSet()
                _decode(chunk_result_set, key_list, wavs[i], orig_bitvec,
                        first_chunk, dev,
                        block_sync=presearched[i] if presearched else None,
                        x=xs[i])
                chunk_result_set.apply_time_offset(chunk[1])
                result_set.merge(chunk_result_set)
                first_chunk = False
    finally:
        if thread is not None:
            thread.join()
        loader.close()

    with prof.phase("get.report"):
        result_set.sort(key_list)
        time_length = int(round(loader.length()))
        return report(result_set, time_length, orig_bitvec)
