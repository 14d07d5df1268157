"""Frame and file integrity checksums for spill IO.

The port's copy of ``spark_rapids_tpu/utils/checksum.py`` (``frame_checksum``
:29, ``file_checksum`` :36, ``verify_frame`` :49): CRC32C where the
``google_crc32c`` wheel is installed, zlib's CRC32 otherwise.  A checksum
of 0 is reserved for "not checksummed": a real CRC of 0 is written as
0xFFFFFFFF, and a verifier accepts any bytes against an expected 0.
"""
from __future__ import annotations

try:                                    # hardware CRC32C when available
    from google_crc32c import extend as _crc_extend
    from google_crc32c import value as _crc
    CHECKSUM_ALGO = "crc32c"
except ImportError:                     # stdlib, the same role
    from zlib import crc32 as _crc
    CHECKSUM_ALGO = "crc32"

    def _crc_extend(crc: int, chunk: bytes) -> int:
        return _crc(chunk, crc)


def frame_checksum(data: bytes) -> int:
    """32-bit checksum of ``data``; never 0."""
    c = _crc(data) & 0xFFFFFFFF
    return c if c else 0xFFFFFFFF


def file_checksum(path: str, chunk_bytes: int = 1 << 20) -> int:
    """``frame_checksum`` of a file's bytes, read in constant memory."""
    c = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            c = _crc_extend(c, chunk) & 0xFFFFFFFF
    return c if c else 0xFFFFFFFF


def verify_frame(data: bytes, expected: int) -> bool:
    """True when ``data`` matches ``expected``; 0 accepts anything."""
    if not expected:
        return True
    return frame_checksum(data) == int(expected)
