"""Stream layout helpers: the 8-byte header of every RLE stream
(format.h:35-45), the headers of the non-RLE streams (the 6-byte simple
one, format.h:64-72, and the legacy xff codec's 8-byte one,
sprintz_xff.cpp:64-69), and the byte-range copy that moves block payloads
between the stream and the dense per-block buffer."""

from __future__ import annotations

import numpy as np

from .constants import METADATA_LEN_RLE


def write_metadata_rle(ngroups: int, remaining_len: int, ndims: int) -> bytes:
    """8-byte stream header {u32 ngroups, u16 remaining_len, u16 ndims} LE."""
    out = bytearray(METADATA_LEN_RLE)
    out[0:4] = int(ngroups).to_bytes(4, "little")
    out[4:6] = int(remaining_len).to_bytes(2, "little")
    out[6:8] = int(ndims).to_bytes(2, "little")
    return bytes(out)


def read_metadata_rle(buf: bytes) -> tuple[int, int, int]:
    """Returns (ngroups, remaining_len, ndims)."""
    ngroups = int.from_bytes(buf[0:4], "little")
    remaining_len = int.from_bytes(buf[4:6], "little")
    ndims = int.from_bytes(buf[6:8], "little")
    return ngroups, remaining_len, ndims


def write_metadata_simple(length: int, ndims: int) -> bytes:
    """6-byte header {u32 len, u16 ndims} LE (format.h:64-72)."""
    return int(length).to_bytes(4, "little") + int(ndims).to_bytes(2, "little")


def read_metadata_simple(buf: bytes) -> tuple[int, int]:
    """Returns (len, ndims)."""
    return (int.from_bytes(buf[0:4], "little"),
            int.from_bytes(buf[4:6], "little"))


def write_metadata_xff(length: int, ndims: int) -> bytes:
    """The legacy xff codec's 8-byte header {u48 len, u16 ndims} LE
    (sprintz_xff.cpp:64-69)."""
    return int(length).to_bytes(6, "little") + int(ndims).to_bytes(2, "little")


def read_metadata_xff(buf: bytes) -> tuple[int, int]:
    """Returns (len, ndims) of a legacy xff header."""
    return (int.from_bytes(buf[0:6], "little"),
            int.from_bytes(buf[6:8], "little"))


def copy_ranges(dst: np.ndarray, dst_off: np.ndarray, src: np.ndarray,
                src_off: np.ndarray, lengths: np.ndarray) -> None:
    """Copy ``lengths[i]`` bytes from ``src[src_off[i]:]`` to
    ``dst[dst_off[i]:]`` for every i, as one gather and one scatter over
    flat uint8 arrays."""
    tot = int(lengths.sum())
    if tot:
        q = np.arange(tot) - np.repeat(np.cumsum(lengths) - lengths, lengths)
        dst[np.repeat(dst_off, lengths) + q] = src[
            np.repeat(src_off, lengths) + q]
