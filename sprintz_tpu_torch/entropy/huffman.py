"""Canonical length-limited Huffman coding in chunks: the +Huf stage.

Counterpart of ``sprintz_tpu/entropy/huffman.py`` (the paper's Huff0
stage, ``communicate/method.tex:300-303``); its containers are the same
bytes. The host keeps what is O(256) or O(chunks): the histogram and the
length-limited table, the container's head and the stored escape. The
per-symbol work runs in ``ops/huffman_kernels.py``: ``encode_chunks``
(``csrc/huffman.cu``'s size and emit passes, a CTA a tile of chunks) and
``decode_chunks`` (K6, the counterpart of the Pallas
``decode_device_pallas``: a CTA a tile of the payload, a chunk's bits cut
into segments that threads decode in parallel, reading from the container
uploaded once).

Stream layout (the JAX package's own; the reference has no in-repo format):
  v2: [u32 n_symbols][u16 chunk_symbols][u16 flags][u32 nchunks]
      [128B lengths table][u16 (flags&2) or u32 payload_nbytes per chunk]
      [chunk payloads...]
  v1 (still read): [u32 n][u32 chunk_symbols][u32 nchunks]
      [128B lengths table][u32 sizes][payloads...], told apart by
      flags == 0 (v1's chunk_symbols high half).
  stored: [u32 n][u16 chunk_symbols][u16 flags = 5][u32 0][n raw bytes],
      written whenever coding does not make the stream smaller.
Each chunk's payload is the LSB-first concatenation of its symbols'
canonical codes, zero-padded to a byte.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from .. import native_host
from ..device import resolve_device
from ..errors import CorruptStreamError
from ..ops.huffman_kernels import (MAX_CODE_LEN, decode_chunks, encode_chunks,
                                   flag_offset)
from ..utils.trace import annotate

# Chunk sizes of auto_chunk_symbols: small chunks (more decode lanes) for
# streams of at least AUTO_CHUNK_MIN_BYTES, large ones (a slightly better
# ratio) below. The JAX package's defaults (config.py:222,
# huffman.py:58,253-261), without its environment overrides.
DEFAULT_CHUNK_SYMBOLS = 128
LARGE_CHUNK_SYMBOLS = 4096
AUTO_CHUNK_MIN_BYTES = 1 << 22
_FLAG_V2 = 1
_FLAG_SIZES_U16 = 2
_FLAG_STORED = 4
_STORED_HEAD_LEN = 12
_TABLE_OFFSET = 12
_SIZES_OFFSET = _TABLE_OFFSET + 128


@dataclasses.dataclass
class HuffmanTable:
    lengths: np.ndarray  # (256,) uint8, 0 = symbol absent
    codes: np.ndarray  # (256,) uint32, canonical, LSB-first bit order

    def canonical_tables(self):
        """Tables of the chunk-parallel decode.

        Returns (limits (11,), adj (13,), perm (256,)) int32:
        - the code length of a bit-reversed 12-bit peek v is
          ``1 + sum_l [v >= limits[l]]`` (limits[l] = left-justified
          first code of length l+2 — canonical levels partition the
          12-bit value space in order),
        - its canonical index is ``(v >> (12 - L)) + adj[L]``,
        - ``perm[index]`` is the symbol (indices enumerate symbols in
          (length, symbol) order — exactly _canonical_codes' order).
        """
        counts = np.bincount(self.lengths, minlength=MAX_CODE_LEN + 1)
        first = np.zeros(MAX_CODE_LEN + 2, dtype=np.int64)
        c = 0
        for ln in range(1, MAX_CODE_LEN + 2):
            first[ln] = c
            c = (c + (counts[ln] if ln <= MAX_CODE_LEN else 0)) << 1
        # left-justified level starts; level l+1's start is level l's end
        lj = np.zeros(MAX_CODE_LEN + 2, dtype=np.int64)
        for ln in range(1, MAX_CODE_LEN + 2):
            lj[ln] = first[ln] << max(MAX_CODE_LEN - ln, 0)
        limits = lj[2 : MAX_CODE_LEN + 1].astype(np.int32)  # (11,)
        # off[L] = number of symbols with shorter codes = cumsum through
        # L-1, excluding counts[0] (absent symbols)
        off = np.cumsum(counts)[:MAX_CODE_LEN] - counts[0]
        adj = np.zeros(MAX_CODE_LEN + 1, dtype=np.int64)
        adj[1:] = off - first[1 : MAX_CODE_LEN + 1]
        perm = np.zeros(256, dtype=np.int32)
        k = 0
        for ln in range(1, MAX_CODE_LEN + 1):
            for s in range(256):
                if self.lengths[s] == ln:
                    perm[k] = s
                    k += 1
        return limits, adj.astype(np.int32), perm


def _limited_lengths(counts: np.ndarray, max_len: int = MAX_CODE_LEN
                     ) -> np.ndarray:
    """Huffman code lengths, limited to max_len via Kraft repair."""
    syms = np.nonzero(counts)[0]
    lengths = np.zeros(256, dtype=np.uint8)
    if len(syms) == 0:
        return lengths
    if len(syms) == 1:
        lengths[syms[0]] = 1
        return lengths
    # standard Huffman on a heap of (count, tiebreak, node)
    heap = [(int(counts[s]), int(s), ("leaf", int(s))) for s in syms]
    heapq.heapify(heap)
    tb = 256
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        heapq.heappush(heap, (c1 + c2, tb, ("node", n1, n2)))
        tb += 1
    stack = [(heap[0][2], 0)]
    while stack:
        node, depth = stack.pop()
        if node[0] == "leaf":
            lengths[node[1]] = max(1, depth)
        else:
            stack.append((node[1], depth + 1))
            stack.append((node[2], depth + 1))
    # length-limit: clamp, then repair Kraft sum by extending the
    # shallowest-clamped codes
    over = lengths > max_len
    if over.any():
        lengths[over] = max_len
        kraft = np.sum((lengths > 0) * (1 << (max_len - lengths.astype(int))))
        while kraft > (1 << max_len):
            # deepen the least-frequent symbol not yet at max_len
            cands = np.nonzero((lengths > 0) & (lengths < max_len))[0]
            s = cands[np.argmin(counts[cands])]
            kraft -= 1 << (max_len - int(lengths[s]))
            lengths[s] += 1
            kraft += 1 << (max_len - int(lengths[s]))
        # tighten codes that can be shortened for free
        while True:
            kraft = np.sum((lengths > 0) * (1 << (max_len - lengths.astype(int))))
            slack = (1 << max_len) - kraft
            cands = np.nonzero(lengths > 1)[0]
            improved = False
            for s in cands[np.argsort(-counts[cands])]:
                gain = 1 << (max_len - int(lengths[s]))
                if gain <= slack:
                    lengths[s] -= 1
                    improved = True
                    break
            if not improved:
                break
    return lengths


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical code assignment, emitted LSB-first (bit-reversed)."""
    codes = np.zeros(256, dtype=np.uint32)
    code = 0
    prev_len = 0
    order = sorted((int(lengths[s]), s) for s in range(256) if lengths[s])
    for L, s in order:
        code <<= (L - prev_len)
        # bit-reverse to make the LSB-first peek index canonical
        rev = int(f"{code:0{L}b}"[::-1], 2)
        codes[s] = rev
        code += 1
        prev_len = L
    return codes


def _as_bytes(data: np.ndarray | bytes) -> np.ndarray:
    return (np.frombuffer(data, dtype=np.uint8)
            if isinstance(data, (bytes, bytearray))
            else np.asarray(data, dtype=np.uint8).reshape(-1))


def build_table(data: np.ndarray | bytes) -> HuffmanTable:
    """The table of ``data``'s symbols; its byte counts come from the port's
    host library (``native_host.histogram``, ``np.bincount``'s counts)."""
    lengths = _limited_lengths(native_host.histogram(_as_bytes(data)))
    return HuffmanTable(lengths=lengths, codes=_canonical_codes(lengths))


def _pack_table(t: HuffmanTable) -> bytes:
    nib = t.lengths.astype(np.uint8)
    return (nib[0::2] | (nib[1::2] << 4)).tobytes()  # 128 bytes


def _unpack_table(buf: bytes) -> HuffmanTable:
    nib = np.frombuffer(buf, dtype=np.uint8)
    lengths = np.zeros(256, dtype=np.uint8)
    lengths[0::2] = nib & 0xF
    lengths[1::2] = nib >> 4
    return HuffmanTable(lengths=lengths, codes=_canonical_codes(lengths))


def _build_head(n: int, chunk_symbols: int, nchunks: int, t: HuffmanTable,
                sizes: np.ndarray) -> bytes:
    """v2 stream header; sizes shrink to u16 whenever they fit."""
    if chunk_symbols >= (1 << 16):
        raise ValueError(
            f"chunk_symbols must fit in u16, got {chunk_symbols} "
            "(the v2 header stores it as u16)")
    u16_ok = sizes.size == 0 or int(sizes.max()) < (1 << 16)
    flags = _FLAG_V2 | (_FLAG_SIZES_U16 if u16_ok else 0)
    return (np.uint32(n).tobytes()
            + np.uint16(chunk_symbols).tobytes() + np.uint16(flags).tobytes()
            + np.uint32(nchunks).tobytes() + _pack_table(t)
            + sizes.astype(np.uint16 if u16_ok else np.uint32).tobytes())


def auto_chunk_symbols(n: int) -> int:
    """Chunk size for a stream of n bytes: DEFAULT_CHUNK_SYMBOLS from
    AUTO_CHUNK_MIN_BYTES up, LARGE_CHUNK_SYMBOLS below."""
    return (DEFAULT_CHUNK_SYMBOLS if n >= AUTO_CHUNK_MIN_BYTES
            else LARGE_CHUNK_SYMBOLS)


def _stored_stream(arr: np.ndarray, chunk_symbols: int) -> bytes:
    return (np.uint32(arr.size).tobytes()
            + np.uint16(chunk_symbols).tobytes()
            + np.uint16(_FLAG_V2 | _FLAG_STORED).tobytes()
            + np.uint32(0).tobytes() + arr.tobytes())


def upload_bytes(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host bytes -> a uint8 tensor on ``device``."""
    if not arr.flags.writeable:  # torch.from_numpy wants a writable array
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def encode_table(t: HuffmanTable, device: torch.device):
    """(codes, lengths) (256,) int32 on ``device``: the encode LUT."""
    return (torch.from_numpy(t.codes.astype(np.int32)).to(device),
            torch.from_numpy(t.lengths.astype(np.int32)).to(device))


@annotate("huf.compress")
def huff_compress(data: np.ndarray | bytes,
                  chunk_symbols: int | None = None,
                  allow_stored: bool = True,
                  device: str | torch.device | None = None) -> bytes:
    """Chunked canonical Huffman encode, byte-identical to the JAX
    package's ``huff_compress``.

    chunk_symbols None = ``auto_chunk_symbols``. Whenever the coded stream
    would be no smaller than raw + 12 bytes the stream is STORED instead;
    ``allow_stored=False`` forces a coded container. ``device``: where the
    per-symbol passes run, CUDA by default; ``"cpu"`` runs their plain
    versions (tests)."""
    arr = _as_bytes(data)
    if chunk_symbols is None:
        chunk_symbols = auto_chunk_symbols(arr.size)
    if not 0 < chunk_symbols < (1 << 16):
        raise ValueError(
            f"chunk_symbols must be in [1, 65535] (u16), got {chunk_symbols}")
    dev = resolve_device(device)
    t = build_table(arr)
    n = arr.size
    nchunks = max(1, -(-n // chunk_symbols))
    if n:
        payload, sizes = encode_chunks(upload_bytes(arr, dev),
                                       *encode_table(t, dev), chunk_symbols)
        sizes_np = sizes.cpu().numpy().astype(np.uint32)
        payload_b = payload.cpu().numpy().tobytes()
    else:  # one empty chunk, as the JAX package writes it
        sizes_np, payload_b = np.zeros(nchunks, np.uint32), b""
    out = _build_head(n, chunk_symbols, nchunks, t, sizes_np) + payload_b
    if allow_stored and n and len(out) >= n + _STORED_HEAD_LEN:
        return _stored_stream(arr, chunk_symbols)
    return out


def is_container(buf: bytes) -> bool:
    """Strict structural check: does ``buf`` parse as a huff_compress
    container (v1, v2, or stored) with an EXACT length match?

    The discriminator behind the zero-overhead stored escape of the +Huf
    codec (``api.py``): when Huffman does not pay, the plain sprintz stream
    ships verbatim, and decompress routes on this check. A plain stream
    that would pass it is never emitted verbatim (it gets the 12-byte
    stored wrapper), so decode never guesses.
    """
    if len(buf) < 12:
        return False
    n = int(np.frombuffer(buf, np.uint32, 1)[0])
    cs16, flags = (int(v) for v in np.frombuffer(buf, np.uint16, 2, offset=4))
    nchunks = int(np.frombuffer(buf, np.uint32, 1, offset=8)[0])
    if flags & _FLAG_STORED:
        return (flags == (_FLAG_V2 | _FLAG_STORED) and nchunks == 0
                and len(buf) == _STORED_HEAD_LEN + n)
    if flags == 0:  # v1: u32 chunk_symbols at 4, u32 sizes
        chunk_symbols, sz_itemsize = int(
            np.frombuffer(buf, np.uint32, 1, offset=4)[0]), 4
    elif flags & _FLAG_V2 and not flags & ~(_FLAG_V2 | _FLAG_SIZES_U16):
        chunk_symbols = cs16
        sz_itemsize = 2 if flags & _FLAG_SIZES_U16 else 4
    else:
        return False
    if chunk_symbols <= 0:
        return False
    if nchunks != -(-n // chunk_symbols) and not (n == 0 and nchunks <= 1):
        return False  # (the encoder emits one empty chunk for n=0)
    payload_start = _SIZES_OFFSET + sz_itemsize * nchunks
    if len(buf) < payload_start:
        return False
    sizes = np.frombuffer(buf, np.uint16 if sz_itemsize == 2 else np.uint32,
                          nchunks, offset=_SIZES_OFFSET)
    if n and (sizes == 0).any():
        return False
    return len(buf) == payload_start + int(sizes.astype(np.int64).sum())


def _parse(buf: bytes):
    """A coded container's (n, chunk_symbols, nchunks, table, sizes,
    offsets); offsets are byte offsets of the chunk payloads in ``buf``.
    Raises ``CorruptStreamError`` where the container does not hold what
    its head declares."""
    if len(buf) < _SIZES_OFFSET:
        raise CorruptStreamError(
            f"Huffman container shorter than its {_SIZES_OFFSET}-byte head "
            f"({len(buf)} bytes)")
    n = int(np.frombuffer(buf, dtype=np.uint32, count=1)[0])
    cs16, flags = np.frombuffer(buf, dtype=np.uint16, count=2, offset=4)
    if flags == 0:  # v1: u32 chunk_symbols, u32 sizes
        chunk_symbols = int(np.frombuffer(buf, np.uint32, 1, offset=4)[0])
        sz_dt = np.uint32
    else:
        chunk_symbols = int(cs16)
        sz_dt = np.uint16 if flags & _FLAG_SIZES_U16 else np.uint32
    nchunks = int(np.frombuffer(buf, dtype=np.uint32, count=1, offset=8)[0])
    t = _unpack_table(buf[_TABLE_OFFSET:_SIZES_OFFSET])
    payload_start = _SIZES_OFFSET + np.dtype(sz_dt).itemsize * nchunks
    if len(buf) < payload_start:
        raise CorruptStreamError(
            f"Huffman container truncated in its chunk sizes ({len(buf)} "
            f"bytes, sizes end at {payload_start})")
    sizes = np.frombuffer(buf, dtype=sz_dt, count=nchunks,
                          offset=_SIZES_OFFSET)
    ends = payload_start + np.cumsum(sizes.astype(np.int64))
    if n and (chunk_symbols <= 0 or nchunks * chunk_symbols < n
              or int(ends[-1]) > len(buf)):
        raise CorruptStreamError(
            f"Huffman container inconsistent: n {n}, chunk_symbols "
            f"{chunk_symbols}, nchunks {nchunks}, payload end "
            f"{int(ends[-1]) if nchunks else payload_start}, length "
            f"{len(buf)}")
    return n, chunk_symbols, nchunks, t, sizes, ends - sizes


def decode_tables(t: HuffmanTable, device: torch.device):
    """(limits (11,), adj (13,), perm (256,)) int32 on ``device``."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in t.canonical_tables())


@annotate("huf.decompress")
def huff_decompress(buf: bytes,
                    device: str | torch.device | None = None) -> np.ndarray:
    """Decode a huff_compress container -> (n,) uint8.

    A stored container's bytes come back as they are. A coded one is
    uploaded once and decoded by K6 on ``device`` (CUDA by default;
    ``"cpu"`` runs its plain version, for tests); symbols and overrun
    count come back in one copy. Raises ``CorruptStreamError`` when a
    chunk's codes run past its payload, as the JAX package's native
    decode does."""
    if len(buf) < _STORED_HEAD_LEN:
        raise CorruptStreamError(
            f"Huffman container shorter than {_STORED_HEAD_LEN} bytes")
    flags = int(np.frombuffer(buf, np.uint16, 1, offset=6)[0])
    if flags & _FLAG_STORED:
        n = int(np.frombuffer(buf, np.uint32, 1)[0])
        if len(buf) < _STORED_HEAD_LEN + n:
            raise CorruptStreamError("stored Huffman container truncated")
        return np.frombuffer(buf, np.uint8, n,
                             offset=_STORED_HEAD_LEN).copy()
    dev = resolve_device(device)
    n, chunk_symbols, nchunks, t, sizes, offsets = _parse(buf)
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    out = decode_chunks(
        upload_bytes(np.frombuffer(buf, np.uint8), dev),
        torch.from_numpy(offsets).to(dev),
        torch.from_numpy(sizes.astype(np.int32)).to(dev),
        *decode_tables(t, dev), chunk_symbols, n).cpu().numpy()
    k = flag_offset(n)
    if int(out[k:k + 4].view(np.int32)[0]):
        raise CorruptStreamError("Huffman payload overran its chunk")
    return out[:n]
