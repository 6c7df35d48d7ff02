"""Debug dump helpers (capability parity with debug_utils.hpp:95-230).

The port's copy of ``sprintz_tpu/utils/debug.py``, its strings the same:
formatting bytes/bits/elements for inspecting packed streams in tests and
notebooks; structured (returns strings) rather than printf-based.
"""

from __future__ import annotations

import numpy as np


def dump_bits(x, lsb_first: bool = True) -> str:
    """Bit string of an int or byte buffer, grouped per byte."""
    if isinstance(x, (bytes, bytearray, np.ndarray)):
        bs = bytes(x)
    else:
        n = max(1, (int(x).bit_length() + 7) // 8)
        bs = int(x).to_bytes(n, "little")
    groups = []
    for b in bs:
        s = f"{b:08b}"
        groups.append(s[::-1] if lsb_first else s)
    return " ".join(groups)


def dump_bytes(buf, per_line: int = 16) -> str:
    bs = bytes(buf)
    lines = []
    for i in range(0, len(bs), per_line):
        chunk = bs[i : i + per_line]
        lines.append(f"{i:6d}: " + " ".join(f"{b:02x}" for b in chunk))
    return "\n".join(lines)


def dump_elements(arr: np.ndarray, ndims: int = 1, max_rows: int = 32) -> str:
    """Rows x dims view of a flat element stream."""
    arr = np.asarray(arr).reshape(-1)
    n = (arr.size // ndims) * ndims
    mat = arr[:n].reshape(-1, ndims)
    lines = [" ".join(f"{v:6d}" for v in row)
             for row in mat[:max_rows].tolist()]
    if mat.shape[0] > max_rows:
        lines.append(f"... ({mat.shape[0] - max_rows} more rows)")
    return "\n".join(lines)


def diff_streams(a: bytes, b: bytes, context: int = 8) -> str:
    """Locate and show the first divergence between two byte streams."""
    if a == b:
        return f"identical ({len(a)} bytes)"
    m = min(len(a), len(b))
    i = next((i for i in range(m) if a[i] != b[i]), m)
    lo = max(0, i - context)
    return (f"lengths {len(a)} vs {len(b)}; first diff at byte {i}\n"
            f"  a[{lo}:{i + context}] = {a[lo:i + context].hex(' ')}\n"
            f"  b[{lo}:{i + context}] = {b[lo:i + context].hex(' ')}")
