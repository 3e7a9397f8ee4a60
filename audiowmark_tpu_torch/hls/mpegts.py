"""MPEG-TS piggyback store, byte-for-byte compatible with the reference.

Copy of audiowmark_tpu/hls/mpegts.py (host code only).

Format (reference: src/mpegts.cc): 188-byte TS packets; payload packets carry
a 12-byte magic header 'G',0x1F,0xFF,0x10,"AWMKfile" (stream start) or
"AWMKdata" (continuation) followed by 176 payload bytes.  An entry is
"<size>:<name>\\0" + data, packetized across as many packets as needed.
`process` copies the original TS packets unchanged and appends the entries.
"""

from __future__ import annotations

import re
import sys
from dataclasses import dataclass
from typing import BinaryIO, Dict, List, Optional

PACKET_SIZE = 188
HEADER_SIZE = 12
_MAGIC_FILE = b"G\x1f\xff\x10AWMKfile"
_MAGIC_DATA = b"G\x1f\xff\x10AWMKdata"


class TSError(Exception):
    pass


@dataclass
class Entry:
    filename: str
    data: bytes


class TSWriter:
    def __init__(self):
        self.entries: List[Entry] = []

    def append_file(self, name: str, filename: str):
        with open(filename, "rb") as f:
            self.entries.append(Entry(name, f.read()))

    def append_vars(self, name: str, vars_map: Dict[str, str]):
        data = bytearray()
        for k in sorted(vars_map):  # std::map iterates in sorted key order
            data += k.encode()
            data += b"="
            data += vars_map[k].encode()
            data += b"\x00"
        self.entries.append(Entry(name, bytes(data)))

    def append_data(self, name: str, data: bytes):
        self.entries.append(Entry(name, bytes(data)))

    def process(self, inname: str, outname: str):
        with open(inname, "rb") as infile, open(outname, "wb") as outfile:
            while True:
                packet = infile.read(PACKET_SIZE)
                if not packet:
                    break
                if len(packet) < PACKET_SIZE:
                    raise TSError("short read while reading transport "
                                  "stream (.ts) packet")
                if packet[0] != ord("G"):
                    raise TSError("bad packet sync while reading transport "
                                  "(.ts) packet")
                outfile.write(packet)

            for entry in self.entries:
                header = b"%d:%s\x00" % (len(entry.data),
                                         entry.filename.encode())
                data = header + entry.data
                pos = 0
                first = True
                while pos < len(data):
                    chunk = data[pos:pos + PACKET_SIZE - HEADER_SIZE]
                    pos += len(chunk)
                    packet = bytearray(PACKET_SIZE)
                    packet[:HEADER_SIZE] = _MAGIC_FILE if first else _MAGIC_DATA
                    packet[HEADER_SIZE:HEADER_SIZE + len(chunk)] = chunk
                    outfile.write(bytes(packet))
                    first = False


class TSReader:
    def __init__(self):
        self.m_entries: List[Entry] = []

    def load(self, inname) -> None:
        if inname == "-":
            self._load_file(sys.stdin.buffer)
        elif isinstance(inname, (bytes, bytearray)):
            import io
            self._load_file(io.BytesIO(inname))
        else:
            with open(inname, "rb") as f:
                self._load_file(f)

    def _load_file(self, infile: BinaryIO):
        awmk_stream = bytearray()
        header_size: Optional[int] = None
        header_name = ""
        while True:
            packet = infile.read(PACKET_SIZE)
            if not packet:
                break
            if len(packet) < PACKET_SIZE:
                raise TSError("short read while reading transport stream "
                              "(.ts) packet")
            if packet[0] != ord("G"):
                raise TSError("bad packet sync while reading transport "
                              "(.ts) packet")
            is_file = packet[:HEADER_SIZE] == _MAGIC_FILE
            is_data = packet[:HEADER_SIZE] == _MAGIC_DATA
            if is_file:
                header_size = None
                awmk_stream.clear()
            if is_file or is_data:
                awmk_stream += packet[HEADER_SIZE:]
                if header_size is None:
                    header_size, header_name = self._parse_header(awmk_stream)
                if header_size is not None and len(awmk_stream) >= header_size:
                    self.m_entries.append(
                        Entry(header_name, bytes(awmk_stream[:header_size])))
                    header_size = None
                    awmk_stream = bytearray()

    @staticmethod
    def _parse_header(data: bytearray):
        zero = data.find(b"\x00")
        if zero < 0:
            return None, ""
        s = data[:zero].decode("latin1")
        m = re.fullmatch(r"([0-9]*):(.*)", s, re.S)
        if not m:
            return None, ""
        size = int(m.group(1) or "0")
        name = m.group(2)
        del data[:zero + 1]
        return size, name

    def entries(self) -> List[Entry]:
        return self.m_entries

    def find(self, name: str) -> Optional[Entry]:
        for entry in self.m_entries:
            if entry.filename == name:
                return entry
        return None

    def parse_vars(self, name: str) -> Dict[str, str]:
        vars_map: Dict[str, str] = {}
        entry = self.find(name)
        if not entry:
            return vars_map
        mode = "KEY"
        s = ""
        key = ""
        for c in entry.data:
            ch = chr(c)
            if ch == "=" and mode == "KEY":
                key = s
                s = ""
                mode = "VALUE"
            elif c == 0 and mode == "VALUE":
                vars_map[key] = s
                s = ""
                mode = "KEY"
            else:
                s += ch
        return vars_map
