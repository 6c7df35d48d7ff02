"""A plain Sprintz codec in NumPy and Python: the benchmark's reference.

It writes and reads the RLE stream format of the reference implementation
(Blalock et al., "Sprintz", arXiv:1808.02515; sprintz_delta_rle.cpp,
sprintz_xff_rle.cpp, sprintz_delta_lowdim.cpp, sprintz_xff_lowdim.cpp):
the delta and FIRE ("xff") forecasters, u8 and u16, the row-major layout
and the low-dimensional (column-major block) layout, zero-run RLE,
group headers and the verbatim tail.

It is written from the format alone and imports nothing of the program
it judges. FIRE is serial over rows in each lane (dim), so it runs as a
Python loop over plain integers; everything else is vectorised NumPy.

``trunc_bits`` sets FIRE's coefficient precision: ``None`` is the
format's own (the full counter in the lowdim layout, its top 4 bits in
the row-major one); a number keeps that many top bits, as the row-major
layout keeps 4. A lower precision than the format's makes the control
that the benchmark's comparison must fail.
"""

from __future__ import annotations

import numpy as np

BLOCK = 8  # rows a block
GROUP = 2  # blocks a group
MAX_RUN = 0x7FFF  # a run's length is a 7/15-bit varint
MIN_DATA = BLOCK * GROUP * 8  # shorter streams are stored verbatim
META = 8  # {u32 ngroups, u16 remaining_len, u16 ndims}, little-endian
LOWDIM_MAX_NDIMS = {1: 4, 2: 2}
FIRE_LEARN_SHIFT = 1  # coefficient = counter >> 1 (before truncation)
FIRE_COUNTER_SHIFT = 2  # counter += grad_sum >> (log2(8) - log2(2))
FIRE_COUNTER_BITS = {1: 16, 2: 32}


def is_lowdim(ndims: int, elem_sz: int) -> bool:
    return ndims <= LOWDIM_MAX_NDIMS[elem_sz]


def format_trunc_bits(ndims: int, elem_sz: int) -> int | None:
    """The coefficient precision the format prescribes for this layout."""
    return None if is_lowdim(ndims, elem_sz) else 4


def _wrap(v: np.ndarray, bits: int) -> np.ndarray:
    """Two's-complement wrap of int64 values to ``bits`` bits."""
    half = 1 << (bits - 1)
    return ((v + half) & ((1 << bits) - 1)) - half


def deltas_of(rows: np.ndarray) -> np.ndarray:
    """(N, D) unsigned rows -> (N, D) int64 signed deltas, from a zero row."""
    eb = 8 * rows.dtype.itemsize
    x = rows.astype(np.int64)
    prev = np.vstack([np.zeros((1, x.shape[1]), np.int64), x[:-1]])
    return _wrap(x - prev, eb)


def fire_encode_lane(deltas: list[int], eb: int, cbits: int,
                     trunc_bits: int | None) -> list[int]:
    """FIRE's errors of one lane, from its deltas (a multiple of 8 rows).

    Per block: coef = counter >> 1, truncated to its top ``trunc_bits`` bits
    (and to 16 bits) where asked; per row: prediction = (prev_delta * coef)
    >> eb, err = delta - prediction; on odd rows the gradient adds
    prev_delta with err's sign; after the block counter += grad_sum >> 2.
    All in the reference's integer types (eb-bit values, 32-bit products,
    a cbits-bit counter)."""
    half, mask = 1 << (eb - 1), (1 << eb) - 1
    chalf, cmask = 1 << (cbits - 1), (1 << cbits) - 1
    shft = 0 if trunc_bits is None else eb - trunc_bits
    errs = [0] * len(deltas)
    counter = 0
    pd = 0
    t = 0
    for _ in range(len(deltas) // BLOCK):
        coef = (counter >> (FIRE_LEARN_SHIFT + shft)) << shft
        if trunc_bits is not None:
            coef = ((coef + 0x8000) & 0xFFFF) - 0x8000
        g = 0
        for i in range(BLOCK):
            d = deltas[t]
            p = pd * coef
            p = ((((p + 0x80000000) & 0xFFFFFFFF) - 0x80000000) >> eb)
            e = ((d - p + half) & mask) - half
            if i & 1:
                if e > 0:
                    g += pd
                elif e < 0:
                    g -= pd
            errs[t] = e
            pd = d
            t += 1
        g = ((g + half) & mask) - half
        counter += g >> FIRE_COUNTER_SHIFT
        counter = ((counter + chalf) & cmask) - chalf
    return errs


def fire_decode_lane(errs: list[int], eb: int, cbits: int,
                     trunc_bits: int | None) -> list[int]:
    """FIRE's inverse: one lane's errors (zero on run rows) -> its values."""
    half, mask = 1 << (eb - 1), (1 << eb) - 1
    chalf, cmask = 1 << (cbits - 1), (1 << cbits) - 1
    shft = 0 if trunc_bits is None else eb - trunc_bits
    vals = [0] * len(errs)
    counter = 0
    pd = 0
    v = 0
    t = 0
    for _ in range(len(errs) // BLOCK):
        coef = (counter >> (FIRE_LEARN_SHIFT + shft)) << shft
        if trunc_bits is not None:
            coef = ((coef + 0x8000) & 0xFFFF) - 0x8000
        g = 0
        for i in range(BLOCK):
            e = errs[t]
            p = pd * coef
            p = ((((p + 0x80000000) & 0xFFFFFFFF) - 0x80000000) >> eb)
            d = ((e + p + half) & mask) - half
            v = (v + d) & mask
            if i & 1:
                if e > 0:
                    g += pd
                elif e < 0:
                    g -= pd
            vals[t] = v
            pd = d
            t += 1
        g = ((g + half) & mask) - half
        counter += g >> FIRE_COUNTER_SHIFT
        counter = ((counter + chalf) & cmask) - chalf
    return vals


def forecast_errors(rows: np.ndarray, codec: str,
                    trunc_bits: int | None) -> np.ndarray:
    """(N, D) rows, N a multiple of 8 -> (N, D) int64 signed errors."""
    deltas = deltas_of(rows)
    if codec == "delta":
        return deltas
    eb = 8 * rows.dtype.itemsize
    cbits = FIRE_COUNTER_BITS[rows.dtype.itemsize]
    out = np.empty_like(deltas)
    for d in range(rows.shape[1]):
        out[:, d] = fire_encode_lane(deltas[:, d].tolist(), eb, cbits,
                                     trunc_bits)
    return out


def zigzag(e: np.ndarray, eb: int) -> np.ndarray:
    return ((e << 1) ^ (e >> (eb - 1))) & ((1 << eb) - 1)


def unzigzag(z: np.ndarray) -> np.ndarray:
    return (z >> 1) ^ -(z & 1)


def block_widths(zz: np.ndarray, eb: int, lowdim: bool) -> np.ndarray:
    """(nb, 8, D) zigzag errors -> (nb, D) widths in bits, as the format
    codes them: lowdim, the bit length with eb-1 promoted to eb; row-major
    u8, the bit length with 7 promoted to 8; row-major u16, a full low byte
    beside any high bits, and the high byte's length promoted as u8's."""
    ormask = np.bitwise_or.reduce(zz, axis=1)
    bl = _bit_length(ormask)
    if lowdim:
        return np.where(bl == eb - 1, eb, bl)
    if eb == 8:
        return np.where(bl == 7, 8, bl)
    hi = _bit_length(ormask >> 8)
    hi = np.where(hi == 7, 8, hi)
    lo = np.where(bl == 7, 8, bl)
    return np.where(hi > 0, 8 + hi, lo)


def _bit_length(v: np.ndarray) -> np.ndarray:
    out = np.zeros(v.shape, np.int64)
    v = v.astype(np.int64)
    for k in range(17):
        out += (v >> k) > 0
    return out


def plan_slots(zero: np.ndarray, n_elems: int, ndims: int,
               run_allows_equal: bool) -> tuple[list, int, int]:
    """The encoder's walk over the blocks' zero flags -> (slots, ngroups,
    blocks consumed). A slot is ("data", block), ("run", length) or
    ("run0", 0); group g owns slots 2g and 2g + 1. A run continues while
    the next block starts before the last full group's start (``<``), or
    at it too (``<=``) in row-major FIRE."""
    block_elems = BLOCK * ndims
    last_start = n_elems - block_elems * GROUP
    slots: list = []
    i = 0  # elements consumed
    b = 0  # next block
    run = 0
    finished = False
    while i <= last_start and not finished:
        pos = 0  # slot within the group
        while pos < GROUP:
            zero_block = bool(zero[b])
            while True:
                if zero_block and run < MAX_RUN:
                    run += 1
                    i += block_elems
                    b += 1
                    more = i <= last_start if run_allows_equal else (
                        i < last_start)
                    if more:
                        break
                    slots.append(("run", run))
                    pos += 1
                    while pos < GROUP:
                        slots.append(("run0", 0))
                        pos += 1
                    run = 0
                    finished = True
                    break
                if run > 0:
                    slots.append(("run", run))
                    pos += 1
                    run = 0
                    if pos == GROUP:
                        pos = 0  # a fresh group; the same block again
                        continue
                    if zero_block:
                        continue  # the run reached its cap on a zero block
                slots.append(("data", b))
                i += block_elems
                b += 1
                pos += 1
                break
            if finished:
                break
    return slots, len(slots) // GROUP, i // block_elems


def _to_bits(v: np.ndarray, nbits: int) -> np.ndarray:
    """Little-endian bits of each value: shape + (nbits,), uint8."""
    return ((v[..., None] >> np.arange(nbits)) & 1).astype(np.uint8)


def pack_payloads(zz: np.ndarray, widths: np.ndarray, eb: int,
                  lowdim: bool) -> tuple[np.ndarray, np.ndarray]:
    """Data blocks' zigzag errors (nd, 8, D) and widths (nd, D) -> (their
    payload bytes end to end, each block's byte length). Lowdim: dim after
    dim, each dim's 8 values of w bits LSB first (w bytes). Row-major:
    8 rows, each the dims' values of w bits LSB first, padded to a byte."""
    nd, _, ndims = zz.shape
    step = max(1, (1 << 22) // (BLOCK * ndims * eb))
    parts = []
    for s in range(0, nd, step):
        z, w = zz[s:s + step], widths[s:s + step]
        if lowdim:
            bits = _to_bits(z.transpose(0, 2, 1), eb)  # (n, D, 8, eb)
            keep = np.arange(eb) < w[:, :, None, None]
            keep = np.broadcast_to(keep, bits.shape)
        else:
            bits = _to_bits(z, eb).reshape(len(z), BLOCK, ndims * eb)
            keep = (np.arange(eb) < w[:, :, None]).reshape(len(z), 1, -1)
            pad = (-w.sum(axis=1)) % 8
            bits = np.concatenate(
                [bits, np.zeros((len(z), BLOCK, 7), np.uint8)], axis=2)
            keep = np.concatenate(
                [keep, (np.arange(7) < pad[:, None])[:, None, :]], axis=2)
            keep = np.broadcast_to(keep, bits.shape)
        parts.append(np.packbits(bits[keep], bitorder="little"))
    wsum = widths.sum(axis=1)
    nbytes = wsum if lowdim else BLOCK * ((wsum + 7) // 8)
    payload = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return payload, nbytes.astype(np.int64)


def _metadata(ngroups: int, remaining: int, ndims: int) -> bytes:
    return (ngroups.to_bytes(4, "little") + remaining.to_bytes(2, "little")
            + ndims.to_bytes(2, "little"))


def encode(x: np.ndarray, codec: str, ndims: int | None = None,
           trunc_bits: int | None = None) -> bytes:
    """Compress (rows, D) or flat u8/u16 data -> the stream's bytes.

    ``trunc_bits``: FIRE's coefficient precision, the format's when None
    (see the module docstring)."""
    x = np.ascontiguousarray(x)
    if ndims is None:
        ndims = 1 if x.ndim == 1 else x.shape[1]
    flat = x.reshape(-1)
    elem_sz = flat.dtype.itemsize
    eb = 8 * elem_sz
    n = flat.size
    if n < MIN_DATA:
        return _metadata(0, n, ndims) + flat.tobytes()
    lowdim = is_lowdim(ndims, elem_sz)
    if trunc_bits is None:
        trunc_bits = format_trunc_bits(ndims, elem_sz)
    nb = n // (BLOCK * ndims)
    rows = flat[: nb * BLOCK * ndims].reshape(-1, ndims)
    zz = zigzag(forecast_errors(rows, codec, trunc_bits), eb).reshape(
        nb, BLOCK, ndims)
    widths = block_widths(zz, eb, lowdim)
    slots, ngroups, consumed = plan_slots(
        widths.sum(axis=1) == 0, n, ndims, codec == "xff" and not lowdim)

    kinds = np.array([k == "data" for k, _ in slots], bool)
    vals = np.array([v for _, v in slots], np.int64)
    data_blocks = vals[kinds]
    payload, nbytes = pack_payloads(zz[data_blocks], widths[data_blocks], eb,
                                    lowdim)

    # headers: each slot's D fields of 3 (u8) or 4 (u16) bits, w - (w == eb)
    hbits = 3 if elem_sz == 1 else 4
    fields = np.zeros((len(slots), ndims), np.int64)
    w = widths[data_blocks]
    fields[kinds] = w - (w == eb)
    hbytes = (ndims * hbits * GROUP + 7) // 8
    hb = _to_bits(fields.reshape(ngroups, GROUP * ndims), hbits).reshape(
        ngroups, -1)
    hb = np.concatenate(
        [hb, np.zeros((ngroups, hbytes * 8 - hb.shape[1]), np.uint8)], axis=1)
    headers = np.packbits(hb, axis=1, bitorder="little").reshape(-1)

    # run varints: 1 byte to 0x7f, else 0x80 | low 7 bits and the high 8
    runs = vals[~kinds]
    two = runs > 0x7F
    run_len = 1 + two.astype(np.int64)
    run_bytes = np.zeros((runs.size, 2), np.int64)
    run_bytes[:, 0] = (runs & 0x7F) | (two << 7)
    run_bytes[:, 1] = runs >> 7
    run_src = run_bytes[np.arange(2) < run_len[:, None]].astype(np.uint8)

    # the stream: for each group its header then its two slots, as
    # segments of one source array
    src = np.concatenate([headers, payload, run_src])
    seg_len = np.zeros(ngroups * (GROUP + 1), np.int64)
    seg_src = np.zeros_like(seg_len)
    seg_len[::GROUP + 1] = hbytes
    seg_src[::GROUP + 1] = np.arange(ngroups) * hbytes
    slot_len = np.zeros(len(slots), np.int64)
    slot_src = np.zeros(len(slots), np.int64)
    slot_len[kinds] = nbytes
    slot_src[kinds] = headers.size + np.cumsum(nbytes) - nbytes
    slot_len[~kinds] = run_len
    slot_src[~kinds] = (headers.size + payload.size + np.cumsum(run_len)
                        - run_len)
    body = np.ones(seg_len.size, bool)
    body[::GROUP + 1] = False
    seg_len[body] = slot_len
    seg_src[body] = slot_src
    starts = np.cumsum(seg_len) - seg_len
    idx = np.repeat(seg_src - starts, seg_len) + np.arange(seg_len.sum())
    tail = flat[consumed * BLOCK * ndims:]
    return (_metadata(ngroups, tail.size, ndims) + src[idx].tobytes()
            + tail.tobytes())


def decode(buf: bytes, codec: str, elem_sz: int,
           trunc_bits: int | None = None) -> np.ndarray:
    """A stream's bytes -> its flat u8/u16 values.

    ``trunc_bits``: FIRE's coefficient precision, the format's when None."""
    udt = np.uint8 if elem_sz == 1 else np.uint16
    eb = 8 * elem_sz
    ngroups = int.from_bytes(buf[0:4], "little")
    remaining = int.from_bytes(buf[4:6], "little")
    ndims = int.from_bytes(buf[6:8], "little")
    if ngroups == 0 and remaining < MIN_DATA:
        return np.frombuffer(buf, udt, remaining, META).copy()
    lowdim = is_lowdim(ndims, elem_sz)
    if trunc_bits is None:
        trunc_bits = format_trunc_bits(ndims, elem_sz)
    hbits = 3 if elem_sz == 1 else 4
    hbytes = (ndims * hbits * GROUP + 7) // 8
    data = np.frombuffer(buf, np.uint8)

    # the header walk: each slot is a data block, a run, or an empty slot
    block_at, block_w, block_off = [], [], []
    row = 0
    pos = META
    for _ in range(ngroups):
        acc = int.from_bytes(buf[pos:pos + hbytes], "little")
        pos += hbytes
        for s in range(GROUP):
            w = []
            for d in range(ndims):
                h = (acc >> ((s * ndims + d) * hbits)) & ((1 << hbits) - 1)
                w.append(eb if h == eb - 1 else h)
            total = sum(w)
            if total == 0:
                length = buf[pos] & 0x7F
                if buf[pos] & 0x80:
                    length |= buf[pos + 1] << 7
                    pos += 1
                pos += 1
                row += length * BLOCK
                continue
            block_at.append(row)
            block_w.append(w)
            block_off.append(pos)
            pos += total if lowdim else BLOCK * ((total + 7) // 8)
            row += BLOCK
    nrows = row

    # unpack every data block's fields, as bit positions in the stream
    zz = np.zeros((nrows, ndims), np.int64)
    if block_at:
        w = np.array(block_w, np.int64)
        off = np.array(block_off, np.int64) * 8
        r = np.arange(BLOCK)
        k = np.arange(eb)
        if lowdim:  # dim d's section starts at the sum of earlier widths
            sec = (np.cumsum(w, axis=1) - w) * BLOCK
            bitpos = (off[:, None, None, None] + sec[:, None, :, None]
                      + r[None, :, None, None] * w[:, None, :, None]
                      + k[None, None, None, :])
        else:  # row r at r * row bytes, dim d at the sum of earlier widths
            rowbits = ((w.sum(axis=1) + 7) // 8) * 8
            bitpos = (off[:, None, None, None]
                      + r[None, :, None, None] * rowbits[:, None, None, None]
                      + (np.cumsum(w, axis=1) - w)[:, None, :, None]
                      + k[None, None, None, :])
        keep = k[None, None, None, :] < w[:, None, :, None]
        bits = np.unpackbits(data, bitorder="little")
        fields = np.where(keep, bits[np.where(keep, bitpos, 0)], 0)
        vals = (fields.astype(np.int64) << k).sum(axis=3)  # (nd, 8, D)
        rows_at = np.array(block_at)[:, None] + r[None, :]
        zz[rows_at.reshape(-1)] = vals.reshape(-1, ndims)
    errs = unzigzag(zz)
    if codec == "delta":
        out = np.cumsum(errs, axis=0) & ((1 << eb) - 1)
    else:
        cbits = FIRE_COUNTER_BITS[elem_sz]
        out = np.empty_like(errs)
        for d in range(ndims):
            out[:, d] = fire_decode_lane(errs[:, d].tolist(), eb, cbits,
                                         trunc_bits)
    tail = np.frombuffer(buf, udt, remaining, pos)
    return np.concatenate([out.astype(udt).reshape(-1), tail])
