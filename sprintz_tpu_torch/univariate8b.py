"""Legacy univariate 8-bit codecs — ALL NINE, byte-exact.

The port's copy of ``sprintz_tpu/golden/univariate8b.py``: host code
(Python loops over samples) there too, so it stays numpy on the host.

The reference carries nine historical univariate codecs
(univariate_8b.cpp:87-1677), precursors of the multivariate design.
Every one is implemented here as an executable format spec,
oracle-verified byte-for-byte against the compiled reference:
delta_simple (nibble-pair headers), delta / doubledelta (3-bit width
headers, separated header area), online / delta_online / delta2_online
(inline per-group headers; raw, lag-1, lag-2 residuals), delta_rle /
delta_rle2 (constant-run varints, block- vs sample-granular), and
dyndelta (:1523-1677 — 4-bit headers = 3-bit width + 1-bit
delta-vs-double-delta choice, the ancestor of the online subsystem's
dynamic predictor selection).

Format (write_size=True):
  [u64 LE original length]
  [ngroups * 4 header bytes]   ngroups = len // 64; per group one u32 LE
      packing 8 x (stored_nbits | choice<<3) 4-bit fields, LSB-first
  [block payloads]             per block: stored_nbits bytes
      (stored 7 means 8 bits/sample -> 8 bytes); samples LSB-first,
      low-n-bits-per-sample two's-complement truncation
  [len % 64 verbatim tail bytes]

Per 8-sample block the encoder computes both the delta and double-delta
residuals (state continuous across blocks/groups), takes whichever
needs fewer signed bits (cost = bit length of the zigzag value,
NBITS_COST_I8 in bitpack.h:43-56), and records choice=1 when
double-delta is strictly better (univariate_8b.cpp:1582).
"""

from __future__ import annotations

import numpy as np

BLOCK_SZ = 8
GROUP_SZ_BLOCKS = 8
GROUP_SZ = BLOCK_SZ * GROUP_SZ_BLOCKS


def _i8(v: int) -> int:
    return ((v + 128) & 0xFF) - 128


def _signed_cost(v: int) -> int:
    """Bits to store v as a signed field = bit_length(zigzag(v));
    matches NBITS_COST_I8 (0 costs 0, -1 costs 1, +1 costs 2...)."""
    zz = (v << 1) ^ (v >> 63) if v >= 0 else ((-v - 1) << 1) + 1
    return int(zz).bit_length()


def compress_dyndelta_8b(x: np.ndarray, write_size: bool = True) -> bytes:
    x = np.ascontiguousarray(x, dtype=np.uint8)
    n = x.size
    ngroups = n // GROUP_SZ
    out = bytearray()
    if write_size:
        out += int(n).to_bytes(8, "little")
    headers = bytearray(ngroups * 4)
    payload = bytearray()

    prev_val = 0
    prev_delta = 0
    pos = 0
    for g in range(ngroups):
        hdr32 = 0
        for b in range(GROUP_SZ_BLOCKS):
            deltas = []
            ddeltas = []
            for i in range(BLOCK_SZ):
                delta = _i8(int(x[pos]) - prev_val)
                ddeltas.append(_i8(delta - prev_delta))
                deltas.append(delta)
                prev_val = int(x[pos])
                prev_delta = delta
                pos += 1
            nb_d = max(_signed_cost(v) for v in deltas)
            nb_dd = max(_signed_cost(v) for v in ddeltas)
            nbits = min(nb_d, nb_dd)
            choice = 1 if nbits < nb_d else 0
            stored = nbits - (nbits == 8)
            hdr32 |= (stored | (choice << 3)) << (4 * b)
            # pack: stored==7 packs full bytes (kBitpackMasks8[7] is the
            # 8-bit mask); otherwise `stored` bits per sample
            m = 8 if stored == 7 else stored
            vals = ddeltas if choice else deltas
            acc = 0
            for i, v in enumerate(vals):
                acc |= (v & ((1 << m) - 1)) << (i * m)
            nbytes = stored + (stored == 7)
            payload += acc.to_bytes(8, "little")[:nbytes]
        headers[g * 4 : (g + 1) * 4] = hdr32.to_bytes(4, "little")
    out += headers
    out += payload
    out += x[ngroups * GROUP_SZ :].tobytes()
    return bytes(out)


def decompress_dyndelta_8b(buf: bytes) -> np.ndarray:
    n = int.from_bytes(buf[:8], "little")
    ngroups = n // GROUP_SZ
    hdr_off = 8
    pos = hdr_off + ngroups * 4
    out = np.empty(n, dtype=np.uint8)
    prev_val = 0
    prev_delta = 0
    o = 0
    for g in range(ngroups):
        hdr32 = int.from_bytes(buf[hdr_off + g * 4 : hdr_off + g * 4 + 4],
                               "little")
        for b in range(GROUP_SZ_BLOCKS):
            field = (hdr32 >> (4 * b)) & 0xF
            stored = field & 0x7
            choice = field >> 3
            m = 8 if stored == 7 else stored
            nbytes = stored + (stored == 7)
            acc = int.from_bytes(buf[pos : pos + 8].ljust(8, b"\0"),
                                 "little")
            pos += nbytes
            for i in range(BLOCK_SZ):
                f = (acc >> (i * m)) & ((1 << m) - 1) if m else 0
                err = f - (1 << m) if m and (f >> (m - 1)) else f
                delta = _i8(err + (prev_delta if choice else 0))
                val = (prev_val + delta) & 0xFF
                out[o] = val
                prev_val = val
                prev_delta = delta
                o += 1
    tail = n - ngroups * GROUP_SZ
    if tail:
        out[o:] = np.frombuffer(buf, np.uint8, count=tail, offset=pos)
    return out


def _pack_block(vals, nbits: int) -> bytes:
    """pext-equivalent: low-m bits of 8 values, LSB-first
    (kBitpackMasks8: widths 7 and 8 both pack full bytes)."""
    m = 8 if nbits >= 7 else nbits
    acc = 0
    for i, v in enumerate(vals):
        acc |= (v & ((1 << m) - 1)) << (i * m)
    nbytes = 8 if nbits >= 7 else nbits
    return acc.to_bytes(8, "little")[:nbytes]


def _group_header_3b(stored: list[int]) -> bytes:
    """8 x 3-bit fields packed LSB-first; written as a u32 whose high
    (4th) byte is 0 — the reference does 4-byte header writes with one
    pad byte after the last group (univariate_8b.cpp:264-267)."""
    acc = 0
    for b, s in enumerate(stored):
        acc |= s << (3 * b)
    return acc.to_bytes(4, "little")


def compress_delta_8b(x: np.ndarray, write_size: bool = True) -> bytes:
    """compress8b_delta (univariate_8b.cpp:196-...): first 8 bytes
    verbatim, then per-64-sample groups of delta blocks with 3-bit width
    headers."""
    x = np.ascontiguousarray(x, dtype=np.uint8)
    n = x.size
    out = bytearray()
    if write_size:
        out += int(n).to_bytes(8, "little")
    cpy = min(8, n)
    out += x[:cpy].tobytes()
    rest = n - cpy
    ngroups = rest // GROUP_SZ
    header_sz = 1 + 3 * ngroups if ngroups else 0
    headers = bytearray(header_sz)
    payload = bytearray()
    pos = cpy
    for g in range(ngroups):
        stored = []
        for b in range(GROUP_SZ_BLOCKS):
            deltas = [_i8(int(x[pos + i]) - int(x[pos + i - 1]))
                      for i in range(BLOCK_SZ)]
            pos += BLOCK_SZ
            nbits = max(_signed_cost(v) for v in deltas)
            stored.append(nbits - (nbits == 8))
            payload += _pack_block(deltas, nbits)
        headers[g * 3 : g * 3 + 4] = _group_header_3b(stored)
    out += headers
    out += payload
    out += x[pos:].tobytes()
    return bytes(out)


def decompress_delta_8b(buf: bytes) -> np.ndarray:
    n = int.from_bytes(buf[:8], "little")
    out = np.empty(n, dtype=np.uint8)
    cpy = min(8, n)
    out[:cpy] = np.frombuffer(buf, np.uint8, count=cpy, offset=8)
    rest = n - cpy
    ngroups = rest // GROUP_SZ
    hdr_off = 8 + cpy
    pos = hdr_off + (1 + 3 * ngroups if ngroups else 0)
    o = cpy
    for g in range(ngroups):
        hdr = int.from_bytes(buf[hdr_off + g * 3 : hdr_off + g * 3 + 3],
                             "little")
        for b in range(GROUP_SZ_BLOCKS):
            stored = (hdr >> (3 * b)) & 0x7
            m = 8 if stored == 7 else stored
            nbytes = 8 if stored == 7 else stored
            acc = int.from_bytes(buf[pos : pos + 8].ljust(8, b"\0"), "little")
            pos += nbytes
            for i in range(BLOCK_SZ):
                f = (acc >> (i * m)) & ((1 << m) - 1) if m else 0
                err = f - (1 << m) if m and (f >> (m - 1)) else f
                out[o] = (int(out[o - 1]) + err) & 0xFF
                o += 1
    tail = n - cpy - ngroups * GROUP_SZ
    if tail:
        out[o:] = np.frombuffer(buf, np.uint8, count=tail, offset=pos)
    return out


def compress_doubledelta_8b(x: np.ndarray, write_size: bool = True) -> bytes:
    """compress8b_doubledelta (univariate_8b.cpp:...): double-delta
    blocks with continuous (prev_val, prev_delta) state from zeros."""
    x = np.ascontiguousarray(x, dtype=np.uint8)
    n = x.size
    out = bytearray()
    if write_size:
        out += int(n).to_bytes(8, "little")
    ngroups = n // GROUP_SZ
    headers = bytearray(1 + 3 * ngroups)
    payload = bytearray()
    prev_val = 0
    prev_delta = 0
    pos = 0
    for g in range(ngroups):
        stored = []
        for b in range(GROUP_SZ_BLOCKS):
            dd = []
            for i in range(BLOCK_SZ):
                delta = _i8(int(x[pos]) - prev_val)
                dd.append(_i8(delta - prev_delta))
                prev_val = int(x[pos])
                prev_delta = delta
                pos += 1
            nbits = max(_signed_cost(v) for v in dd)
            stored.append(nbits - (nbits == 8))
            payload += _pack_block(dd, nbits)
        headers[g * 3 : g * 3 + 4] = _group_header_3b(stored)
    out += headers
    out += payload
    out += x[pos:].tobytes()
    return bytes(out)


def decompress_doubledelta_8b(buf: bytes) -> np.ndarray:
    n = int.from_bytes(buf[:8], "little")
    ngroups = n // GROUP_SZ
    hdr_off = 8
    pos = hdr_off + 1 + 3 * ngroups
    out = np.empty(n, dtype=np.uint8)
    prev_val = 0
    prev_delta = 0
    o = 0
    for g in range(ngroups):
        hdr = int.from_bytes(buf[hdr_off + g * 3 : hdr_off + g * 3 + 3],
                             "little")
        for b in range(GROUP_SZ_BLOCKS):
            stored = (hdr >> (3 * b)) & 0x7
            m = 8 if stored == 7 else stored
            nbytes = 8 if stored == 7 else stored
            acc = int.from_bytes(buf[pos : pos + 8].ljust(8, b"\0"), "little")
            pos += nbytes
            for i in range(BLOCK_SZ):
                f = (acc >> (i * m)) & ((1 << m) - 1) if m else 0
                err = f - (1 << m) if m and (f >> (m - 1)) else f
                delta = _i8(err + prev_delta)
                val = (prev_val + delta) & 0xFF
                out[o] = val
                prev_val = val
                prev_delta = delta
                o += 1
    tail = n - ngroups * GROUP_SZ
    if tail:
        out[o:] = np.frombuffer(buf, np.uint8, count=tail, offset=pos)
    return out


def compress_delta_simple_8b(x: np.ndarray, write_size: bool = True) -> bytes:
    """compress8b_delta_simple (univariate_8b.cpp:87-150): 2-block
    groups, one header byte per group (two 4-bit width nibbles),
    continuous delta state from 0, trailing len%16 verbatim."""
    x = np.ascontiguousarray(x, dtype=np.uint8)
    n = x.size
    nblocks = n // BLOCK_SZ
    ngroups = n // 16
    out = bytearray()
    if write_size:
        out += int(n).to_bytes(8, "little")
    headers = bytearray(nblocks // 2)
    payload = bytearray()
    prev_val = 0
    pos = 0
    for g in range(ngroups):
        nibs = []
        for _b in range(2):
            deltas = []
            for _i in range(BLOCK_SZ):
                deltas.append(_i8(int(x[pos]) - prev_val))
                prev_val = int(x[pos])
                pos += 1
            nbits = max(_signed_cost(v) for v in deltas)
            nbits += nbits == 7  # 7b treated as 8b at decoder
            nibs.append(nbits - (nbits == 8))
            m = 8 if nbits == 8 else nbits
            acc = 0
            for i, v in enumerate(deltas):
                acc |= (v & ((1 << m) - 1)) << (i * m)
            payload += acc.to_bytes(8, "little")[:nbits]
        headers[g] = nibs[0] | (nibs[1] << 4)
    out += headers
    out += payload
    out += x[pos:].tobytes()
    return bytes(out)


def decompress_delta_simple_8b(buf: bytes) -> np.ndarray:
    n = int.from_bytes(buf[:8], "little")
    nblocks = n // BLOCK_SZ
    ngroups = n // 16
    hdr_off = 8
    pos = hdr_off + nblocks // 2
    out = np.empty(n, dtype=np.uint8)
    prev_val = 0
    o = 0
    for g in range(ngroups):
        hdr = buf[hdr_off + g]
        for nib in (hdr & 0xF, hdr >> 4):
            nbits = 8 if nib == 7 else nib
            m = nbits
            acc = int.from_bytes(buf[pos : pos + 8].ljust(8, b"\0"), "little")
            pos += nbits
            for i in range(BLOCK_SZ):
                f = (acc >> (i * m)) & ((1 << m) - 1) if m else 0
                err = f - (1 << m) if m and (f >> (m - 1)) else f
                prev_val = (prev_val + err) & 0xFF
                out[o] = prev_val
                o += 1
    tail = n - ngroups * 16
    if tail:
        out[o:] = np.frombuffer(buf, np.uint8, count=tail, offset=pos)
    return out


def _varint15(length: int) -> bytes:
    if length > 0x7F:
        return bytes([(length & 0x7F) | 0x80, length >> 7])
    return bytes([length & 0x7F])


def compress_delta_rle_8b(x: np.ndarray, write_size: bool = True) -> bytes:
    """compress8b_delta_rle (univariate_8b.cpp): per-group 3-byte width
    headers placed BEFORE each group's payload; zero-delta (constant)
    block runs collapse to a 7/15-bit varint in a width-0 slot. Metadata
    is {u32 ngroups, u32 len - ngroups*64}; the first sample is stored
    verbatim. Mirrors the reference's end-of-data abort path (varint +
    zero-filled remaining slots) and run-cap re-entry exactly."""
    x = np.ascontiguousarray(x, dtype=np.uint8)
    n = x.size
    body = bytearray()
    cpy = min(1, n)
    body += x[:cpy].tobytes()
    p = cpy
    last_full = n - GROUP_SZ
    ngroups = 0
    finished = False

    def read_block(p):
        deltas = [_i8(int(x[p + i]) - int(x[p + i - 1]))
                  for i in range(BLOCK_SZ)]
        return deltas, max(_signed_cost(v) for v in deltas)

    while p <= last_full and not finished:
        slots = [0] * GROUP_SZ_BLOCKS
        pieces = bytearray()
        b = 0
        ncb = 0
        while b < GROUP_SZ_BLOCKS:
            deltas, nbits = read_block(p)
            p += BLOCK_SZ
            slots[b] = nbits - (nbits == 8)
            while nbits == 0 and ncb < 0x7FFF:
                ncb += 1
                if p < last_full + BLOCK_SZ * b:
                    deltas, nbits = read_block(p)
                    p += BLOCK_SZ
                else:
                    # end-of-data abort: emit run, fill remaining slots
                    # with empty (zero-length) runs
                    slots[b] = 0
                    b += 1
                    pieces += _varint15(ncb)
                    while b < GROUP_SZ_BLOCKS:
                        slots[b] = 0
                        pieces += b"\x00"
                        b += 1
                    finished = True
                    break
            if finished:
                break
            if ncb:
                slots[b] = 0
                b += 1
                pieces += _varint15(ncb)
                p -= BLOCK_SZ  # re-read the nonzero block
                ncb = 0
                continue
            m = 8 if nbits >= 7 else nbits
            acc = 0
            for i, v in enumerate(deltas):
                acc |= (v & ((1 << m) - 1)) << (i * m)
            pieces += acc.to_bytes(8, "little")[: 8 if nbits >= 7 else nbits]
            b += 1
        hdr = 0
        for i, s in enumerate(slots):
            hdr |= s << (3 * i)
        body += hdr.to_bytes(3, "little")
        body += pieces
        ngroups += 1
    body += x[p:].tobytes()
    meta = (int(ngroups).to_bytes(4, "little")
            + int(n - ngroups * GROUP_SZ).to_bytes(4, "little", signed=False)
            ) if write_size else b""
    return bytes(meta + body)


def decompress_delta_rle_8b(buf: bytes) -> np.ndarray:
    ngroups = int.from_bytes(buf[0:4], "little")
    extra = int.from_bytes(buf[4:8], "little")
    n = ngroups * GROUP_SZ + extra
    out = np.empty(n, dtype=np.uint8)
    cpy = min(1, n)
    if cpy:
        out[0] = buf[8]
    pos = 8 + cpy
    prev_val = int(out[0]) if cpy else 0
    o = cpy
    for _g in range(ngroups):
        hdr = int.from_bytes(buf[pos : pos + 3], "little")
        pos += 3
        for b in range(GROUP_SZ_BLOCKS):
            nbits = (hdr >> (3 * b)) & 0x7
            if nbits == 0:
                low = buf[pos]
                high = buf[pos + 1] if (low & 0x80) else 0
                length = (low & 0x7F) | (high << 7)
                out[o : o + length * BLOCK_SZ] = prev_val
                o += length * BLOCK_SZ
                pos += 1 + (1 if high > 0 else 0)
                continue
            m = 8 if nbits == 7 else nbits
            nbytes = 8 if nbits == 7 else nbits
            acc = int.from_bytes(buf[pos : pos + 8].ljust(8, b"\0"), "little")
            pos += nbytes
            for i in range(BLOCK_SZ):
                f = (acc >> (i * m)) & ((1 << m) - 1)
                err = f - (1 << m) if (f >> (m - 1)) else f
                prev_val = (prev_val + err) & 0xFF
                out[o] = prev_val
                o += 1
    remaining = n - o
    if remaining:
        out[o:] = np.frombuffer(buf, np.uint8, count=remaining, offset=pos)
    return out


def _compress_inline_groups(x: np.ndarray, cpy_len: int, lag: int,
                            write_size: bool) -> bytes:
    """Shared skeleton of the "online" legacy trio (univariate_8b.cpp):
    u64 length, cpy_len verbatim samples, then per-group [3-byte header]
    [8 packed blocks]; residual = x[i] - x[i-lag] (lag 0 = raw bytes).
    """
    x = np.ascontiguousarray(x, dtype=np.uint8)
    n = x.size
    out = bytearray()
    if write_size:
        out += int(n).to_bytes(8, "little")
    cpy = min(cpy_len, n)
    out += x[:cpy].tobytes()
    rest = n - cpy
    ngroups = rest // GROUP_SZ
    pos = cpy
    for _g in range(ngroups):
        slots = []
        pieces = bytearray()
        for _b in range(GROUP_SZ_BLOCKS):
            if lag == 0:
                vals = [_i8(int(x[pos + i])) for i in range(BLOCK_SZ)]
            else:
                vals = [_i8(int(x[pos + i]) - int(x[pos + i - lag]))
                        for i in range(BLOCK_SZ)]
            pos += BLOCK_SZ
            nbits = max(_signed_cost(v) for v in vals)
            slots.append(nbits - (nbits == 8))
            pieces += _pack_block(vals, nbits)
        hdr = 0
        for i, s in enumerate(slots):
            hdr |= s << (3 * i)
        out += hdr.to_bytes(3, "little")
        out += pieces
    out += x[pos:].tobytes()
    return bytes(out)


def _decompress_inline_groups(buf: bytes, cpy_len: int, lag: int
                              ) -> np.ndarray:
    n = int.from_bytes(buf[:8], "little")
    out = np.empty(n, dtype=np.uint8)
    cpy = min(cpy_len, n)
    out[:cpy] = np.frombuffer(buf, np.uint8, count=cpy, offset=8)
    rest = n - cpy
    ngroups = rest // GROUP_SZ
    pos = 8 + cpy
    o = cpy
    for _g in range(ngroups):
        hdr = int.from_bytes(buf[pos : pos + 3], "little")
        pos += 3
        for b in range(GROUP_SZ_BLOCKS):
            stored = (hdr >> (3 * b)) & 0x7
            m = 8 if stored == 7 else stored
            nbytes = 8 if stored == 7 else stored
            acc = int.from_bytes(buf[pos : pos + 8].ljust(8, b"\0"), "little")
            pos += nbytes
            for i in range(BLOCK_SZ):
                f = (acc >> (i * m)) & ((1 << m) - 1) if m else 0
                err = f - (1 << m) if m and (f >> (m - 1)) else f
                if lag == 0:
                    out[o] = err & 0xFF
                else:
                    out[o] = (int(out[o - lag]) + err) & 0xFF
                o += 1
    tail = n - cpy - ngroups * GROUP_SZ
    if tail:
        out[o:] = np.frombuffer(buf, np.uint8, count=tail, offset=pos)
    return out


def compress_online_8b(x, write_size=True):
    """compress8b_online: bitpack-only, inline headers, 8-sample prefix."""
    return _compress_inline_groups(x, 8, 0, write_size)


def decompress_online_8b(buf):
    return _decompress_inline_groups(buf, 8, 0)


def compress_delta_online_8b(x, write_size=True):
    """compress8b_delta_online: lag-1 delta, inline headers, 1-sample
    prefix."""
    return _compress_inline_groups(x, 1, 1, write_size)


def decompress_delta_online_8b(buf):
    return _decompress_inline_groups(buf, 1, 1)


def compress_delta2_online_8b(x, write_size=True):
    """compress8b_delta2_online: lag-2 difference (delta_delay=2),
    inline headers, 8-sample prefix."""
    return _compress_inline_groups(x, 8, 2, write_size)


def decompress_delta2_online_8b(buf):
    return _decompress_inline_groups(buf, 8, 2)


def compress_delta_rle2_8b(x: np.ndarray, write_size: bool = True) -> bytes:
    """compress8b_delta_rle2: like delta_rle but run lengths are counted
    in SAMPLES (nconstant_blocks<<3 plus the run-ending block's leading
    zero deltas via tzcnt), the two samples after a run are stored
    verbatim, and the block after a run resumes past those samples."""
    x = np.ascontiguousarray(x, dtype=np.uint8)
    n = x.size
    body = bytearray()
    cpy = min(1, n)
    body += x[:cpy].tobytes()
    p = cpy
    last_full = n - GROUP_SZ
    ngroups = 0
    finished = False

    def read_block(p):
        deltas = [_i8(int(x[p + i]) - int(x[p + i - 1]))
                  for i in range(BLOCK_SZ)]
        return deltas, max(_signed_cost(v) for v in deltas)

    while p <= last_full and not finished:
        slots = [0] * GROUP_SZ_BLOCKS
        pieces = bytearray()
        b = 0
        ncb = 0
        while b < GROUP_SZ_BLOCKS:
            deltas, nbits = read_block(p)
            p += BLOCK_SZ
            slots[b] = nbits - (nbits == 8)
            while nbits == 0 and ncb < (0x7FFF >> 3):
                ncb += 1
                if p < last_full + BLOCK_SZ * (b - 1):
                    deltas, nbits = read_block(p)
                    p += BLOCK_SZ
                else:
                    slots[b] = 0
                    b += 1
                    length = ncb << 3
                    pieces += _varint15(length)
                    if length > 0:
                        pieces += x[p : p + 2].tobytes()
                        p += 2
                    while b < GROUP_SZ_BLOCKS:
                        slots[b] = 0
                        pieces += b"\x00"
                        b += 1
                    finished = True
                    break
            if finished:
                break
            if ncb:
                slots[b] = 0
                b += 1
                # leading zero deltas of the run-ending block extend the
                # run (tzcnt of the delta bytes; all-zero -> 0 via &0x7)
                tz = 0
                for v in deltas:
                    if v == 0:
                        tz += 1
                    else:
                        break
                additional = tz & 0x7
                length = (ncb << 3) + additional
                pieces += _varint15(length)
                p = p - BLOCK_SZ + additional
                if length > 0:
                    pieces += x[p : p + 2].tobytes()
                    p += 2
                ncb = 0
                continue
            m = 8 if nbits >= 7 else nbits
            acc = 0
            for i, v in enumerate(deltas):
                acc |= (v & ((1 << m) - 1)) << (i * m)
            pieces += acc.to_bytes(8, "little")[: 8 if nbits >= 7 else nbits]
            b += 1
        hdr = 0
        for i, s in enumerate(slots):
            hdr |= s << (3 * i)
        body += hdr.to_bytes(3, "little")
        body += pieces
        ngroups += 1
    body += x[p:].tobytes()
    meta = (int(ngroups).to_bytes(4, "little")
            + int(n - ngroups * GROUP_SZ).to_bytes(4, "little")
            ) if write_size else b""
    return bytes(meta + body)


def decompress_delta_rle2_8b(buf: bytes) -> np.ndarray:
    ngroups = int.from_bytes(buf[0:4], "little")
    extra = int.from_bytes(buf[4:8], "little")
    n = ngroups * GROUP_SZ + extra
    out = np.empty(n, dtype=np.uint8)
    cpy = min(1, n)
    if cpy:
        out[0] = buf[8]
    pos = 8 + cpy
    prev_val = int(out[0]) if cpy else 0
    o = cpy
    for _g in range(ngroups):
        hdr = int.from_bytes(buf[pos : pos + 3], "little")
        pos += 3
        for b in range(GROUP_SZ_BLOCKS):
            nbits = (hdr >> (3 * b)) & 0x7
            if nbits == 0:
                low = buf[pos]
                high = buf[pos + 1] if (low & 0x80) else 0
                length = (low & 0x7F) | (high << 7)
                out[o : o + length] = prev_val
                o += length
                pos += 1 + (1 if high > 0 else 0)
                if length:
                    out[o : o + 2] = np.frombuffer(
                        buf, np.uint8, count=2, offset=pos)
                    pos += 2
                    o += 2
                    prev_val = int(out[o - 1])
                continue
            m = 8 if nbits == 7 else nbits
            nbytes = 8 if nbits == 7 else nbits
            acc = int.from_bytes(buf[pos : pos + 8].ljust(8, b"\0"), "little")
            pos += nbytes
            for i in range(BLOCK_SZ):
                f = (acc >> (i * m)) & ((1 << m) - 1)
                err = f - (1 << m) if (f >> (m - 1)) else f
                prev_val = (prev_val + err) & 0xFF
                out[o] = prev_val
                o += 1
    remaining = n - o
    if remaining:
        out[o:] = np.frombuffer(buf, np.uint8, count=remaining, offset=pos)
    return out
