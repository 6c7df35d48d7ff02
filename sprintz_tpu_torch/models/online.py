"""Online/streaming subsystem: scalar predictor state machines, dynamic
per-block predictor choice, and the ``sprintzpack`` univariate u16 codec.

The port's copy of ``sprintz_tpu/models/online.py``: a per-sample host
codec there too, so it stays numpy on the host and takes no device.

Capability parity with the reference's 2020 streaming layer
(online.hpp:118-382, online.cpp:17-660), byte-exact where a format exists:

- predictors with init/jump/predict/train: Delta (online.hpp:118-141),
  DoubleDelta (:143-186), TripleDelta (:189-249), MovingAvg (:251-285)
- PredictiveCoder encode/decode and whole-buffer drivers (:288-382)
- dynamic per-8-block choice between delta and double-delta, recorded as a
  1-bit-per-block choices bitfield, with MaxAbs / SumLogAbs losses
  (online.cpp:17-160); the SumLogAbs length term reproduces the
  reference's uint8 wraparound of ``16 - clz32(v)`` (a quirk of
  online.cpp:42-45 under lzcnt semantics) for stream compatibility
- sprintzpack: per-8-block 4-bit-width bitpacking without pext
  (online.cpp:363-626), plus the pack/unpack wrappers with the 4-byte
  simple1d metadata header

Whole-buffer transforms for the delta family are also exposed as
vectorized numpy operations (repeated wraparound differencing / prefix
sums).
"""

from __future__ import annotations

import numpy as np

U16 = np.uint16
I16 = np.int16


def _wrap_i16(x) -> int:
    return ((int(x) + 0x8000) & 0xFFFF) - 0x8000


def _wrap_u16(x) -> int:
    return int(x) & 0xFFFF


class DeltaPredictor:
    """prev-value predictor (online.hpp:118-141)."""

    def init(self, v):
        self._prev = _wrap_u16(v)

    def jump(self, p0, p1, p2):
        self._prev = _wrap_u16(p0)

    def predict(self):
        return self._prev

    def train(self, err, true_val):
        self._prev = _wrap_u16(true_val)


class DoubleDeltaPredictor:
    """linear extrapolation from the previous diff (online.hpp:143-186)."""

    def init(self, v):
        self._prev_val = _wrap_u16(v)
        self._prev_diff = 0

    def jump(self, p0, p1, p2):
        self._prev_val = _wrap_u16(p0)
        self._prev_diff = _wrap_i16(p0 - p1)

    def predict(self):
        return _wrap_u16(self._prev_val + self._prev_diff)

    def train(self, err, true_val):
        self._prev_diff = _wrap_i16(true_val - self._prev_val)
        self._prev_val = _wrap_u16(true_val)


class TripleDeltaPredictor:
    """quadratic extrapolation (online.hpp:189-249)."""

    def init(self, v):
        self._prev_val = _wrap_u16(v)
        self._prev_diff = 0
        self._prev_ddiff = 0

    def jump(self, p0, p1, p2):
        self._prev_val = _wrap_u16(p0)
        self._prev_diff = _wrap_i16(p0 - p1)
        self._prev_ddiff = _wrap_i16(self._prev_diff - _wrap_i16(p1 - p2))

    def predict(self):
        pd = _wrap_i16(self._prev_diff + self._prev_ddiff)
        return _wrap_u16(self._prev_val + pd)

    def train(self, err, true_val):
        diff = _wrap_i16(true_val - self._prev_val)
        self._prev_ddiff = _wrap_i16(diff - self._prev_diff)
        self._prev_diff = diff
        self._prev_val = _wrap_u16(true_val)


class MovingAvgPredictor:
    """quarter-weight IIR via an accumulator (online.hpp:251-285)."""

    SHIFT = 2

    def init(self, v):
        self._acc = _wrap_u16(v) << self.SHIFT

    def jump(self, p0, p1, p2):
        raise ValueError("finite history invalid for IIR filter")

    def predict(self):
        return (self._acc >> self.SHIFT) & 0xFFFF

    def train(self, err, true_val):
        self._acc += _wrap_i16(err)


class PredictiveCoder:
    """encode_next/decode_next/train wrapper (online.hpp:288-341)."""

    def __init__(self, predictor):
        self._p = predictor

    def init(self, v):
        self._p.init(v)

    def jump(self, p0, p1, p2):
        self._p.jump(p0, p1, p2)

    def encode_next(self, val):
        err = _wrap_i16(_wrap_u16(val) - self._p.predict())
        self._p.train(err, val)
        return err

    def decode_next(self, err):
        val = _wrap_u16(self._p.predict() + _wrap_i16(err))
        self._p.train(err, val)
        return val

    def train(self, true_val):
        err = _wrap_i16(_wrap_u16(true_val) - self._p.predict())
        self._p.train(err, true_val)


def predictive_encode(data: np.ndarray, predictor_cls) -> np.ndarray:
    """Whole-buffer scalar driver (online.hpp:343-368): out[0] = in[0]."""
    data = np.asarray(data, dtype=U16)
    out = np.empty(data.size, dtype=I16)
    if data.size == 0:
        return out
    out[0] = data[0].astype(np.uint16).view(np.int16)
    coder = PredictiveCoder(predictor_cls())
    coder.init(int(data[0]))
    for i in range(1, data.size):
        out[i] = coder.encode_next(int(data[i]))
    return out


def predictive_decode(errs: np.ndarray, predictor_cls) -> np.ndarray:
    errs = np.asarray(errs, dtype=I16)
    out = np.empty(errs.size, dtype=U16)
    if errs.size == 0:
        return out
    out[0] = errs[0].view(np.uint16)
    coder = PredictiveCoder(predictor_cls())
    coder.init(int(out[0]))
    for i in range(1, errs.size):
        out[i] = coder.decode_next(int(errs[i]))
    return out


# ------------------------------------------------- vectorized delta family


def nth_order_delta_encode(data: np.ndarray, order: int) -> np.ndarray:
    """Vectorized equivalent of predictive_encode for the delta family:
    order 1 = delta, 2 = double delta, 3 = triple delta. Exact wraparound
    match of the scalar coders (verified in tests)."""
    x = np.asarray(data, dtype=U16).view(I16).astype(np.int32)
    out = x.copy()
    for _ in range(order):
        prev = np.concatenate([[0], out[:-1]])
        out = out - prev
        if out.size:
            out[0] = 0  # coder state starts at (x0, diff=0, ddiff=0)
    # first element is always the raw value
    res = (out & 0xFFFF).astype(np.uint16).view(I16)
    if data.size:
        res[0] = np.asarray(data, dtype=U16)[0].view(I16)
    return res


def nth_order_delta_decode(errs: np.ndarray, order: int) -> np.ndarray:
    e = np.asarray(errs, dtype=I16).astype(np.int64)
    if e.size == 0:
        return e.astype(U16)
    x0 = int(np.asarray(errs, dtype=I16)[0].view(U16))
    out = e.copy()
    out[0] = 0
    for _ in range(order):
        out = np.cumsum(out)
    return ((out + x0) & 0xFFFF).astype(U16)


# ------------------------------------------------- dynamic predictor choice

LOSS_MAX_ABS = 0
LOSS_SUM_LOG_ABS = 1


def _zz16(err: int) -> int:
    v = _wrap_i16(err)
    return ((v << 1) ^ (v >> 15)) & 0xFFFF


def _unzz16(u: int) -> int:
    return _wrap_i16((u >> 1) ^ -(u & 1))


def _loss(block: list[int], loss: int) -> int:
    if loss == LOSS_MAX_ABS:
        return max(block)
    total = 0
    for v in block:
        clz = 32 if v == 0 else 32 - int(v).bit_length()
        total += (16 - clz) & 0xFF  # uint8 wrap, as compiled from
        # online.cpp:42-45 (clz semantics per lzcnt)
    return total


def dynamic_delta_zigzag_encode(
    data: np.ndarray, loss: int = LOSS_SUM_LOG_ABS, block_sz: int = 8
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (errs int16 array incl. verbatim first element, choices bytes).

    Per block, delta and double-delta coders run in parallel (both always
    trained on true values); the lower-loss one's zigzagged errors are
    emitted and its id recorded as 1 bit (online.cpp:47-160)."""
    data = np.asarray(data, dtype=U16)
    n = data.size
    out = np.empty(n, dtype=I16)
    if n == 0:
        return out, np.zeros(0, dtype=np.uint8)
    out[0] = data[0].view(I16)
    length = n - 1
    nblocks = length // block_sz
    choices = np.zeros((max(nblocks, 0) + 7) // 8, dtype=np.uint8)
    if n == 1:
        return out, choices
    enc0 = PredictiveCoder(DeltaPredictor())
    enc1 = PredictiveCoder(DoubleDeltaPredictor())
    enc0.init(int(data[0]))
    enc1.init(int(data[0]))
    pos = 1
    for b in range(nblocks):
        t0, t1 = [], []
        for _ in range(block_sz):
            val = int(data[pos])
            pos += 1
            t0.append(_zz16(enc0.encode_next(val)))
            t1.append(_zz16(enc1.encode_next(val)))
        if _loss(t0, loss) <= _loss(t1, loss):
            chosen, choice = t0, 0
        else:
            chosen, choice = t1, 1
        for bb, u in enumerate(chosen):
            out[pos - block_sz + bb] = np.uint16(u).view(I16)
        choices[b // 8] |= choice << (b % 8)
    while pos < n:  # delta-coded tail
        out[pos] = np.uint16(
            enc0.encode_next(int(data[pos])) & 0xFFFF).view(I16)
        pos += 1
    return out, choices


def dynamic_delta_zigzag_decode(
    errs: np.ndarray, choices: np.ndarray, block_sz: int = 8
) -> np.ndarray:
    errs = np.asarray(errs, dtype=I16)
    n = errs.size
    out = np.empty(n, dtype=U16)
    if n == 0:
        return out
    out[0] = errs[0].view(U16)
    if n == 1:
        return out
    length = n - 1
    nblocks = length // block_sz
    enc0 = PredictiveCoder(DeltaPredictor())
    enc1 = PredictiveCoder(DoubleDeltaPredictor())
    enc0.init(int(out[0]))
    enc1.init(int(out[0]))
    pos = 1
    for b in range(nblocks):
        choice = (int(choices[b // 8]) >> (b % 8)) & 1
        coder = enc1 if choice else enc0
        other = enc0 if choice else enc1
        for _ in range(block_sz):
            u = int(errs[pos].view(U16))
            out[pos] = coder.decode_next(_unzz16(u))
            pos += 1
        # resync the unused coder from the last 3 decoded values
        # (online.cpp:224-236)
        other.jump(int(out[pos - 1]), int(out[pos - 2]), int(out[pos - 3]))
    while pos < n:
        out[pos] = enc0.decode_next(int(errs[pos]))
        pos += 1
    return out


def dynamic_delta_pack_u16(data: np.ndarray,
                           loss: int = LOSS_SUM_LOG_ABS) -> bytes:
    """[u32 len][int16 errs x len][choices bytes, padded to u16]
    (online.cpp:275-296)."""
    data = np.asarray(data, dtype=U16)
    errs, choices = dynamic_delta_zigzag_encode(data, loss)
    # reserved choices region sizes by ceil(n/8) blocks — including the
    # partial tail block that is never choice-coded (online.cpp:258-263,
    # 287-291), padded to a whole u16
    reserved = (-(-data.size // 8) + 7) // 8
    padded = ((reserved + 1) // 2) * 2
    cbytes = np.zeros(padded, dtype=np.uint8)
    cbytes[: choices.size] = choices
    return (int(data.size).to_bytes(4, "little") + errs.tobytes()
            + cbytes.tobytes())


def dynamic_delta_unpack_u16(buf: bytes) -> np.ndarray:
    n = int.from_bytes(buf[:4], "little")
    errs = np.frombuffer(buf, dtype=I16, count=n, offset=4)
    reserved = (-(-n // 8) + 7) // 8
    choices = np.frombuffer(buf, dtype=np.uint8,
                            count=reserved, offset=4 + 2 * n)
    return dynamic_delta_zigzag_decode(errs, choices)


# ------------------------------------------------- sprintzpack (u16)


def _needed_nbits_u16x8(block: np.ndarray) -> int:
    """Max bit length over the block, with 15 promoted to 16
    (bitpack.h:273-287)."""
    m = int(np.bitwise_or.reduce(block.astype(np.uint32)))
    w = m.bit_length()
    return 16 if w == 15 else w


def sprintzpack_encode_u16(data: np.ndarray, zigzag: bool = True,
                           block_sz: int = 8) -> tuple[bytes, bytes]:
    """Returns (payload bytes incl. verbatim tail, 4-bit headers bytes)."""
    data = np.asarray(data, dtype=U16)
    n = data.size
    nblocks = n // block_sz
    headers = np.zeros((nblocks * 4 + 7) // 8, dtype=np.uint8)
    payload = bytearray()
    for b in range(nblocks):
        block = data[b * block_sz : (b + 1) * block_sz]
        if zigzag:
            s = block.view(I16).astype(np.int32)
            block = (((s << 1) ^ (s >> 15)) & 0xFFFF).astype(U16)
        nbits = _needed_nbits_u16x8(block)
        write_nbits = nbits - (1 if nbits == 16 else 0)
        if b % 2:
            headers[b // 2] |= write_nbits << 4
        else:
            headers[b // 2] = write_nbits
        acc = 0
        for i, v in enumerate(block.tolist()):
            acc |= int(v) << (i * nbits)
        payload += acc.to_bytes(nbits, "little") if nbits else b""
    payload += data[nblocks * block_sz :].tobytes()
    return bytes(payload), headers.tobytes()


def sprintzpack_decode_u16(payload: bytes, headers: bytes, n: int,
                           zigzag: bool = True, block_sz: int = 8
                           ) -> np.ndarray:
    out = np.empty(n, dtype=U16)
    nblocks = n // block_sz
    pos = 0
    hdr = np.frombuffer(headers, dtype=np.uint8)
    for b in range(nblocks):
        h = (hdr[b // 2] >> (4 if b % 2 else 0)) & 0xF
        nbits = 16 if h == 15 else int(h)
        if nbits:
            acc = int.from_bytes(payload[pos : pos + nbits], "little")
            pos += nbits
        else:
            acc = 0
        mask = (1 << nbits) - 1
        for i in range(block_sz):
            v = (acc >> (i * nbits)) & mask
            if zigzag:
                v = _unzz16(v) & 0xFFFF
            out[b * block_sz + i] = v
    tail = np.frombuffer(payload, dtype=U16,
                         count=n - nblocks * block_sz, offset=pos)
    out[nblocks * block_sz :] = tail
    return out


def sprintzpack_pack_u16(data: np.ndarray, zigzag: bool = False) -> bytes:
    """[u32 len][headers padded to u16][payload, padded to u16]
    (online.cpp:655-668)."""
    data = np.asarray(data, dtype=U16)
    n = data.size
    payload, headers = sprintzpack_encode_u16(data, zigzag=zigzag)
    # reserved header region sizes by ceil(n/8) blocks incl. the partial
    # tail block (online.cpp:355-360, 655-664), padded to a whole u16
    hdr_reserved = (-(-n // 8) * 4 + 7) // 8
    hdr_padded = ((hdr_reserved + 1) // 2) * 2
    h = np.zeros(hdr_padded, dtype=np.uint8)
    used = np.frombuffer(headers, dtype=np.uint8)
    h[: used.size] = used
    body = payload + (b"\x00" if len(payload) % 2 else b"")
    return int(n).to_bytes(4, "little") + h.tobytes() + body


def sprintzpack_unpack_u16(buf: bytes, zigzag: bool = False) -> np.ndarray:
    n = int.from_bytes(buf[:4], "little")
    hdr_reserved = (-(-n // 8) * 4 + 7) // 8
    hdr_padded = ((hdr_reserved + 1) // 2) * 2
    headers = buf[4 : 4 + hdr_reserved]
    payload = buf[4 + hdr_padded :]
    return sprintzpack_decode_u16(payload, headers, n, zigzag=zigzag)


def zigzag_pack_u16(data: np.ndarray) -> bytes:
    """[u32 len][zigzagged int16 x len] (online.cpp:322-336)."""
    data = np.asarray(data, dtype=U16)
    s = data.view(I16).astype(np.int32)
    zz = (((s << 1) ^ (s >> 15)) & 0xFFFF).astype(U16)
    return int(data.size).to_bytes(4, "little") + zz.tobytes()


def zigzag_unpack_u16(buf: bytes) -> np.ndarray:
    n = int.from_bytes(buf[:4], "little")
    zz = np.frombuffer(buf, dtype=U16, count=n, offset=4).astype(np.int64)
    return (((zz >> 1) ^ -(zz & 1)) & 0xFFFF).astype(U16)
