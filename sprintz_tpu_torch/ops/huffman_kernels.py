"""Chunk-parallel Huffman kernels: the per-symbol passes of +Huf.

Counterpart of the device passes of ``sprintz_tpu/entropy/huffman.py`` and
``entropy/pallas_huffman.py``. Two wrappers over ``csrc/huffman.cu``:

- ``decode_chunks`` (K6, ``huff_decode_kernel``), the counterpart of the
  Pallas ``decode_device_pallas`` with its fused permutation: each chunk's
  canonical codes -> its symbols, one thread per chunk, reading the chunk's
  bytes from the uploaded container at ``offsets[c]``, guarded by
  ``sizes[c]``.
- ``encode_chunks`` (``huff_encode_sizes_kernel`` then
  ``huff_encode_emit_kernel``), the counterpart of the XLA append scan of
  ``huffman.py:736-808``: symbols -> each chunk's payload bytes and size,
  a CTA a tile of whole chunks (``huff_tile_chunks``), 16 symbols a
  thread.

Each wrapper launches its kernels for a CUDA tensor and runs its plain
PyTorch version (computed in int64: torch's uint32 has few CPU ops) for a
CPU tensor, and counts its calls that launch in ``launches``.
"""

from __future__ import annotations

import torch

from . import _build
from .decode_kernels import check_args

MAX_CODE_LEN = 12
# A CTA of the encoder codes a tile of whole chunks, about ENC_TILE_SYMBOLS
# symbols (16 for each of its 256 threads), or one longer chunk.
ENC_TILE_SYMBOLS = 4096


def huff_tile_chunks(chunk_symbols: int) -> int:
    """The chunks of an encoder tile at this chunk size."""
    return max(1, ENC_TILE_SYMBOLS // chunk_symbols)


def _rev12(x: torch.Tensor) -> torch.Tensor:
    """Bit-reverse the low 12 bits (4 swap rounds)."""
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> 4


# ------------------------------------------------------------------ K6


def decode_chunks_plain(data: torch.Tensor, offsets: torch.Tensor,
                        sizes: torch.Tensor, limits: torch.Tensor,
                        adj: torch.Tensor, perm: torch.Tensor,
                        chunk_symbols: int, n: int) -> torch.Tensor:
    """Plain version of ``decode_chunks``: every chunk advances one symbol
    per step, peeking 12 bits at its bit cursor from a 3-byte window."""
    nchunks = offsets.shape[0]
    off, sz = offsets.long(), sizes.long()
    lim, adjl, perml = limits.long(), adj.long(), perm.long()
    last = max(data.shape[0] - 1, 0)
    bitpos = torch.zeros(nchunks, dtype=torch.int64, device=data.device)
    out = torch.empty((nchunks, chunk_symbols), dtype=torch.uint8,
                      device=data.device)
    for i in range(chunk_symbols):
        q = bitpos >> 3
        w = torch.zeros_like(bitpos)
        for k in range(3):  # a 12-bit peek at bit offset <= 7 spans 3 bytes
            j = q + k
            byte = data[(off + j).clamp(max=last)].long()
            w |= torch.where(j < sz, byte, 0) << (8 * k)
        v = _rev12((w >> (bitpos & 7)) & 0xFFF)
        length = 1 + (v[:, None] >= lim[None, :]).sum(dim=1)
        idx = ((v >> (MAX_CODE_LEN - length)) + adjl[length]).clamp(0, 255)
        out[:, i] = perml[idx].to(torch.uint8)
        bitpos += length
    return out.reshape(-1)[:n]


def decode_chunks(data: torch.Tensor, offsets: torch.Tensor,
                  sizes: torch.Tensor, limits: torch.Tensor,
                  adj: torch.Tensor, perm: torch.Tensor,
                  chunk_symbols: int, n: int) -> torch.Tensor:
    """Canonical Huffman decode of every chunk of a container.

    data (B,) uint8, the container; offsets (C,) int64 and sizes (C,)
    int32, each chunk's payload bytes in it; limits (11,), adj (13,), perm
    (256,) int32 from ``HuffmanTable.canonical_tables``. Chunk c holds
    symbols c * chunk_symbols onwards; a chunk reads its bytes past its
    size as zeros. Returns the first n symbols, (n,) uint8, with
    ``n <= C * chunk_symbols``.
    """
    check_args("decode_chunks", data.device, data=(data, torch.uint8),
               offsets=(offsets, torch.int64), sizes=(sizes, torch.int32),
               limits=(limits, torch.int32), adj=(adj, torch.int32),
               perm=(perm, torch.int32))
    nchunks = offsets.shape[0]
    if (tuple(sizes.shape) != (nchunks,) or limits.shape != (MAX_CODE_LEN - 1,)
            or adj.shape != (MAX_CODE_LEN + 1,) or perm.shape != (256,)):
        raise ValueError("decode_chunks: offsets/sizes are not (C,), or the "
                         "tables are not (11,), (13,), (256,)")
    if not 0 <= n <= nchunks * chunk_symbols or chunk_symbols <= 0:
        raise ValueError(f"decode_chunks: n {n} symbols do not fit "
                         f"{nchunks} chunks of {chunk_symbols}")
    if data.device.type == "cpu":
        return decode_chunks_plain(data, offsets, sizes, limits, adj, perm,
                                   chunk_symbols, n)
    out = torch.empty(n, dtype=torch.uint8, device=data.device)
    if n == 0:
        return out
    _build.launch("sprintz_huff_decode", data, data.data_ptr(),
                  offsets.data_ptr(), sizes.data_ptr(), limits.data_ptr(),
                  adj.data_ptr(), perm.data_ptr(), out.data_ptr(), nchunks,
                  chunk_symbols, n)
    decode_chunks.launches += 1
    return out


decode_chunks.launches = 0


# -------------------------------------------------------------- encode


def encode_chunks_plain(syms: torch.Tensor, codes: torch.Tensor,
                        lengths: torch.Tensor, chunk_symbols: int):
    """Plain version of ``encode_chunks``: each symbol's code lands at its
    bit offset (the per-chunk prefix of the code lengths, plus 8 x the
    chunk's byte offset) as up to 3 bytes; codes are bit-disjoint, so the
    sum of the bytes is their OR."""
    n = syms.shape[0]
    nchunks = -(-n // chunk_symbols)
    pad = nchunks * chunk_symbols - n
    s = syms.long()
    ln = torch.nn.functional.pad(lengths.long()[s], (0, pad)).view(
        nchunks, chunk_symbols)
    cd = torch.nn.functional.pad(codes.long()[s], (0, pad)).view(
        nchunks, chunk_symbols)
    bit_off = torch.cumsum(ln, dim=1) - ln
    sizes = (bit_off[:, -1] + ln[:, -1] + 7) >> 3
    byte_off = torch.cumsum(sizes, dim=0) - sizes
    pos = byte_off[:, None] * 8 + bit_off
    total = int(sizes.sum())
    out = torch.zeros(total + 3, dtype=torch.int64, device=syms.device)
    word = (cd << (pos & 7)).reshape(-1)  # <= 19 bits
    q = (pos >> 3).reshape(-1)
    for k in range(3):
        out.scatter_add_(0, q + k, (word >> (8 * k)) & 0xFF)
    return out[:total].to(torch.uint8), sizes.to(torch.int32)


def encode_chunks(syms: torch.Tensor, codes: torch.Tensor,
                  lengths: torch.Tensor, chunk_symbols: int):
    """syms (n,) uint8, n > 0; codes, lengths (256,) int32 (the table's
    LSB-first canonical codes and their lengths, 0..12) -> (payload
    (sum(sizes),) uint8, sizes (C,) int32), C = ceil(n / chunk_symbols).

    Chunk c's payload is the LSB-first concatenation of the codes of
    symbols c * chunk_symbols onwards, zero-padded to a byte; the payloads
    follow each other in chunk order.
    """
    check_args("encode_chunks", syms.device, syms=(syms, torch.uint8),
               codes=(codes, torch.int32), lengths=(lengths, torch.int32))
    if (syms.dim() != 1 or syms.shape[0] == 0 or codes.shape != (256,)
            or lengths.shape != (256,) or chunk_symbols <= 0):
        raise ValueError("encode_chunks: syms must be (n,) with n > 0, the "
                         "tables (256,), chunk_symbols > 0")
    if syms.device.type == "cpu":
        return encode_chunks_plain(syms, codes, lengths, chunk_symbols)
    n = syms.shape[0]
    nchunks = -(-n // chunk_symbols)
    tile = huff_tile_chunks(chunk_symbols)
    sizes = torch.empty(nchunks, dtype=torch.int32, device=syms.device)
    _build.launch("sprintz_huff_encode_sizes", syms, syms.data_ptr(),
                  lengths.data_ptr(), sizes.data_ptr(), n, chunk_symbols, tile)
    ends = torch.cumsum(sizes, dim=0, dtype=torch.int64)
    # The payload's size is copied out behind the cumsum, and the host waits
    # for that copy only once the emit pass is queued too: the card never
    # idles between the passes. The payload is allocated at its bound (12
    # bits a symbol, a pad byte a chunk).
    stream = torch.cuda.current_stream(syms.device)
    total = torch.empty(1, dtype=torch.int64, pin_memory=True)
    total.copy_(ends[-1:], non_blocking=True)
    copied = torch.cuda.Event()
    copied.record(stream)
    payload = torch.empty(-(-MAX_CODE_LEN * n // 8) + nchunks,
                          dtype=torch.uint8, device=syms.device)
    _build.launch("sprintz_huff_encode_emit", syms, syms.data_ptr(),
                  codes.data_ptr(), lengths.data_ptr(), ends.data_ptr(),
                  sizes.data_ptr(), payload.data_ptr(), n, chunk_symbols,
                  tile)
    encode_chunks.launches += 1
    copied.synchronize()
    return payload[:int(total)], sizes


encode_chunks.launches = 0
