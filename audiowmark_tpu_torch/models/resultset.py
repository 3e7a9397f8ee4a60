"""Pattern result collection, rating, ordering and reporting.

A copy of audiowmark_tpu/models/resultset.py, importing the port's
ConvBlockType (the JAX package's module imports jax through its codec).
Mirrors ResultSet (src/wmget.cc:163-474): dedup/merge across chunks, rating
by summed sync quality (x2 for ALL patterns), deterministic sort order, text
and JSON output formats byte-compatible with the reference.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from enum import Enum
from typing import List, Optional

from ..crypto.keys import Key
from ..params import Params
from ..utils.hexbits import bit_vec_to_str

from ..codec.convcode import ConvBlockType


class PatternType(Enum):
    BLOCK = 0
    CLIP = 1
    ALL = 2


@dataclass
class Pattern:
    key: Key
    time: float
    bit_vec: List[int]
    decode_error: float
    sync_quality: float
    sync_block_type: ConvBlockType
    type: PatternType
    speed: float
    rating: float = 0.0

    def approx_match(self, p: "Pattern") -> bool:
        time_delta = Params.frame_size / float(Params.mark_sample_rate)
        speed_delta = 0.01
        return (self.key == p.key
                and (abs(self.time - p.time) < time_delta
                     or self.type == PatternType.ALL)
                and list(self.bit_vec) == list(p.bit_vec)
                and self.sync_block_type == p.sync_block_type
                and self.type == p.type
                and abs(self.speed - p.speed) < speed_delta)


def _json_escape(s: str) -> str:
    out = []
    for ch in s:
        if ch in ('"', "\\"):
            out.append("\\" + ch)
        elif ord(ch) < 32:
            out.append("\\u%04x" % ord(ch))
        else:
            out.append(ch)
    return "".join(out)


class ResultSet:
    def __init__(self):
        self.patterns: List[Pattern] = []
        self.debug_sync = ""

    def add_pattern(self, key: Key, time: float, sync_quality: float,
                    sync_block_type: ConvBlockType, bit_vec, decode_error: float,
                    pattern_type: PatternType, speed: float):
        self.patterns.append(Pattern(
            key=key, time=time, bit_vec=list(map(int, bit_vec)),
            decode_error=float(decode_error), sync_quality=float(sync_quality),
            sync_block_type=sync_block_type, type=pattern_type, speed=speed))

    def apply_time_offset(self, time_offset: float):
        for p in self.patterns:
            p.time += time_offset

    def _rate_patterns(self, key: Key):
        rating = {}
        for p in self.patterns:
            if p.key == key:
                all_factor = 2.0 if p.type == PatternType.ALL else 1.0
                bits = bit_vec_to_str(p.bit_vec)
                rating[bits] = rating.get(bits, 0.0) + p.sync_quality * all_factor
        for p in self.patterns:
            if p.key == key:
                p.rating = rating[bit_vec_to_str(p.bit_vec)]

    def sort(self, key_list: List[Key]):
        for key in key_list:
            self._rate_patterns(key)

        def ab(p: Pattern) -> int:
            return {ConvBlockType.a: 0, ConvBlockType.b: 1,
                    ConvBlockType.ab: 2}[p.sync_block_type]

        def sort_key(p: Pattern):
            return (p.key.name(), -p.rating, 1 if p.type == PatternType.ALL else 0,
                    p.time, ab(p), bit_vec_to_str(p.bit_vec))

        self.patterns.sort(key=sort_key)

    def merge(self, other: "ResultSet"):
        to_merge = sorted(other.patterns, key=lambda p: p.time)
        for p in to_merge:
            if not any(my_p.approx_match(p) for my_p in self.patterns):
                self.patterns.append(p)
        if not self.debug_sync:
            self.debug_sync = other.debug_sync

    def _btype_str(self, p: Pattern) -> str:
        btype = {ConvBlockType.a: "A", ConvBlockType.b: "B",
                 ConvBlockType.ab: "AB"}[p.sync_block_type]
        if p.type == PatternType.ALL:
            btype = "ALL"
        if p.type == PatternType.CLIP:
            btype = "CLIP-" + btype
        if p.speed != 1:
            btype += "-SPEED"
        return btype

    def print_json(self, time_length: int, json_file: str):
        try:
            f = sys.stdout if json_file == "-" else open(json_file, "w")
        except OSError as e:
            from ..utils.log import error
            error("audiowmark: failed to write results to '%s': %s\n"
                  % (json_file, e))
            sys.exit(127)  # reference: src/wmget.cc print_json perror+exit
        try:
            f.write('{ "length": "%d:%02d",\n'
                    % (time_length // 60, time_length % 60))
            f.write('  "matches": [\n')
            rows = []
            for p in self.patterns:
                seconds = int(p.time)
                rows.append(
                    '    { "key": "%s", "pos": "%d:%02d", "bits": "%s", '
                    '"quality": %.5f, "error": %.6f, "rating": %.5f, '
                    '"type": "%s", "speed": %.6f }'
                    % (_json_escape(p.key.name()), seconds // 60, seconds % 60,
                       bit_vec_to_str(p.bit_vec), p.sync_quality,
                       p.decode_error, p.rating, self._btype_str(p), p.speed))
            f.write(",\n".join(rows))
            f.write(" ]\n}\n")
        finally:
            if f is not sys.stdout:
                f.close()

    def print(self):
        last_key_name: Optional[str] = None
        print_speed = True
        for p in self.patterns:
            if p.key.name() != last_key_name:
                print("key %s" % p.key.name())
                last_key_name = p.key.name()
                print_speed = True
            if print_speed:
                for q in self.patterns:
                    if q.key == p.key and q.speed != 1:
                        print("speed %.6f" % q.speed)
                        break
                print_speed = False
            if p.type == PatternType.ALL:
                extra = " SPEED" if p.speed != 1 else ""
                print("pattern   all %s %.3f %.3f%s"
                      % (bit_vec_to_str(p.bit_vec), p.sync_quality,
                         p.decode_error, extra))
            else:
                block_str = {ConvBlockType.a: "A", ConvBlockType.b: "B",
                             ConvBlockType.ab: "AB"}[p.sync_block_type]
                if p.type == PatternType.CLIP:
                    block_str = "CLIP-" + block_str
                if p.speed != 1:
                    block_str += "-SPEED"
                seconds = int(p.time)
                print("pattern %2d:%02d %s %.3f %.3f %s"
                      % (seconds // 60, seconds % 60,
                         bit_vec_to_str(p.bit_vec), p.sync_quality,
                         p.decode_error, block_str))

    def print_match_count(self, orig_bits: List[int]) -> int:
        match_count = sum(1 for p in self.patterns
                          if p.bit_vec == list(orig_bits))
        print("match_count %d %d" % (match_count, len(self.patterns)))
        return match_count
