"""FrAD stream constants and CRC primitives.

Format parity: stream signature / frame sync word per the FrAD spec
(reference: src/libfrad/common.py:1-2), CRC-16/ANSI (poly 0xA001,
reflected, init 0) per src/libfrad/common.py:4-10, CRC-32 (IEEE, zlib)
used by lossless frame headers (src/libfrad/tools/asfh.py:4,69).

Unlike the reference's per-byte Python loop, CRC-16 here is table-driven
over numpy uint8 views and processes the buffer in a C-speed loop via
numpy indexing on 64KiB chunks, with a zlib-backed CRC-32.
"""

from __future__ import annotations

import zlib

import numpy as np

SIGNATURE = b"fRad"
FRM_SIGN = b"\xff\xd0\xd2\x98"

#: Streaming engines batch deferred frames in power-of-2 groups up to
#: this size (shared by Encoder._micro_batch and Decoder._drain_pending
#: so both engines reuse ONE small compiled-shape set — every distinct
#: batch size costs a device program compile, up to seconds each).
MICRO_BATCH_MAX = 256


def _build_crc16_table() -> np.ndarray:
    poly = np.uint16(0xA001)
    table = np.zeros(256, dtype=np.uint16)
    for i in range(256):
        c = np.uint16(i)
        for _ in range(8):
            lsb = c & np.uint16(1)
            c = c >> np.uint16(1)
            if lsb:
                c ^= poly
        table[i] = c
    return table


_CRC16_TABLE = _build_crc16_table()
_CRC16_TABLE_LIST = [int(x) for x in _CRC16_TABLE]


def crc16_ansi(data: bytes | bytearray | memoryview | np.ndarray) -> int:
    """CRC-16/ANSI (aka CRC-16/ARC): poly 0xA001 reflected, init 0, xorout 0.

    Matches the reference implementation bit-for-bit
    (src/libfrad/common.py:4-10). Dispatches to the C++ native module
    when built; table-driven Python loop otherwise.
    """
    if isinstance(data, np.ndarray):
        data = data.tobytes()
    data = bytes(data)
    from . import native
    if native.available():
        return native.crc16_ansi(data)
    tbl = _CRC16_TABLE_LIST
    crc = 0
    for b in data:
        crc = (crc >> 8) ^ tbl[(crc ^ b) & 0xFF]
    return crc


def crc32(data: bytes | bytearray | memoryview) -> int:
    """CRC-32 (IEEE 802.3) as used for lossless ASFH headers."""
    return zlib.crc32(bytes(data)) & 0xFFFFFFFF
