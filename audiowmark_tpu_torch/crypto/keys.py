"""Watermarking keys: 128-bit AES keys with names and key-file I/O.

Reference semantics: src/random.cc:192-373 — zero key by default, test keys
as big-endian uint64 in the first 8 bytes, key files with a small tokenizer
supporting quoting, escapes and # comments.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..utils.hexbits import hex_str_to_vec
from ..utils.log import error

KEY_SIZE = 16  # 128 bits


class KeyError_(Exception):
    pass


def _string_char(ch: str) -> bool:
    return (ch.isascii() and ch.isalnum()) or ch in ".:=/-_"


def _white_space(ch: str) -> bool:
    return ch in " \n\t\r"


def tokenize(line: str) -> Optional[List[str]]:
    """Tokenize one key-file line; None on parse error.

    States: blank / string / quoted string (with backslash escapes) /
    comment (reference: src/random.cc:232-293).
    """
    BLANK, STRING, QSTRING, QESC, COMMENT = range(5)
    state = BLANK
    tokens: List[str] = []
    s = ""
    for ch in line + "\n":
        if state == BLANK and _string_char(ch):
            state = STRING
            s += ch
        elif state == BLANK and ch == '"':
            state = QSTRING
        elif state == BLANK and _white_space(ch):
            pass
        elif state == STRING and _string_char(ch):
            s += ch
        elif (state == STRING and _white_space(ch)) or (state == QSTRING and ch == '"'):
            tokens.append(s)
            s = ""
            state = BLANK
        elif state == QSTRING and ch == "\\":
            state = QESC
        elif state == QSTRING:
            s += ch
        elif state == QESC:
            s += ch
            state = QSTRING
        elif ch == "#":
            state = COMMENT
        elif state == COMMENT:
            pass
        else:
            return None
    if state in (BLANK, COMMENT):
        return tokens
    return None


class Key:
    """128-bit AES key + display name; default is the all-zero key."""

    SIZE = KEY_SIZE

    def __init__(self):
        self._aes_key = bytes(KEY_SIZE)
        self._name = ""

    def __eq__(self, other):
        return (isinstance(other, Key)
                and self._aes_key == other._aes_key
                and self._name == other._name)

    def __hash__(self):
        return hash((self._aes_key, self._name))

    def set_test_key(self, key: int):
        """Big-endian uint64 in the first 8 bytes (src/random.cc:202-207)."""
        self._aes_key = (key & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big") + bytes(8)
        self._name = "test-key-%d" % key

    def load_key(self, key_file: str):
        try:
            with open(key_file, "r") as f:
                lines = f.readlines()
        except OSError:
            error("audiowmark: error opening key file: '%s'\n" % key_file)
            raise SystemExit(1)

        self._name = os.path.basename(key_file)

        keys = 0
        for lineno, line in enumerate(lines, 1):
            tokens = tokenize(line)
            parse_ok = False
            if tokens is not None:
                if len(tokens) == 2 and tokens[0] == "key":
                    key = hex_str_to_vec(tokens[1])
                    if key is None or len(key) != KEY_SIZE:
                        error("audiowmark: wrong key length in key file '%s', line %d\n"
                              " => required key length is %d bits\n"
                              % (key_file, lineno, KEY_SIZE * 8))
                        raise SystemExit(1)
                    self._aes_key = key
                    keys += 1
                    parse_ok = True
                if len(tokens) == 2 and tokens[0] == "name":
                    self._name = tokens[1]
                    parse_ok = True
                if not tokens:
                    parse_ok = True
            if not parse_ok:
                error("audiowmark: parse error in key file '%s', line %d\n"
                      % (key_file, lineno))
                raise SystemExit(1)

        if keys > 1:
            error("audiowmark: key file '%s' contains more than one key\n" % key_file)
            raise SystemExit(1)
        if keys == 0:
            error("audiowmark: key file '%s' contains no key\n" % key_file)
            raise SystemExit(1)

    def aes_key(self) -> bytes:
        return self._aes_key

    def name(self) -> str:
        return self._name
