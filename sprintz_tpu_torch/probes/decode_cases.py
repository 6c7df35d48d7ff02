"""The decode side's edge cases: Huffman containers on which K6
``decode_chunks`` must equal its plain version, symbols and overrun flags.

One list for two users: ``tests/test_torch_huffman_decode.py`` holds the
plain version to the JAX package on these containers on the CPU, and
``chip_smoke.py`` holds the kernel to the plain version on the same
containers on the card. Containers are made on the CPU from the caller's
generator. Not imported by the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..entropy import huffman as hf
from ..ops.huffman_kernels import encode_chunks
from . import encode_cases as ec

DECODE_CHUNKS = ec.HUFF_CHUNKS
DECODE_KINDS = ec.HUFF_KINDS + ("padding", "overrun middle", "overrun end")
DECODE_CASES = [(cs, kind) for cs in DECODE_CHUNKS for kind in DECODE_KINDS]


def container(data: np.ndarray, cs: int, t: hf.HuffmanTable | None = None
              ) -> bytes:
    """A coded container of ``data`` at chunk size cs, with the table t
    (default: the data's own), never the stored escape."""
    t = hf.build_table(data) if t is None else t
    payload, sizes = encode_chunks(torch.from_numpy(data.copy()),
                                   *hf.encode_table(t, "cpu"), cs)
    sizes_np = sizes.numpy().astype(np.uint32)
    return (hf._build_head(data.size, cs, sizes_np.size, t, sizes_np)
            + payload.numpy().tobytes())


def overrun(buf: bytes, chunk: int) -> bytes:
    """``buf`` with chunk ``chunk``'s size lowered by one and its last byte
    dropped: the chunk's codes then end past its payload, which the
    decoders must flag. Every other chunk keeps its bytes."""
    _, _, nchunks, _, sizes, offsets = hf._parse(buf)
    dt = sizes.dtype
    sizes = sizes.copy()
    sizes[chunk] -= 1
    start = hf._SIZES_OFFSET
    cut = int(offsets[chunk]) + int(sizes[chunk])  # the dropped byte
    return (buf[:start] + sizes.astype(dt).tobytes()
            + buf[start + dt.itemsize * nchunks:cut] + buf[cut + 1:])


def decode_case(rng, cs: int, kind: str):
    """-> (container bytes, the symbols coded in it (n,) uint8, the number
    of chunks the decoders must flag).

    The kinds of ``encode_cases.huff_case`` (a ragged last chunk, fewer
    symbols than a chunk, only 12-bit codes, one symbol value), and:

    - "padding": three symbols, the likeliest with the 1-bit all-zero
      code, so a chunk's zero padding decodes to extra symbols (checked);
    - "overrun middle", "overrun end": skewed symbols of the "ragged"
      shape, then the middle or the last chunk overrun (``overrun``).
    """
    if kind in ec.HUFF_KINDS:
        data, t = ec.huff_case(rng, cs, kind)
        return container(data, cs, t), data, 0
    data, _ = ec.huff_case(rng, cs, "ragged")
    if kind == "padding":
        data = rng.choice(np.array([5, 77, 200], np.uint8), data.size,
                          p=[0.6, 0.2, 0.2])
        buf = container(data, cs)
        t = hf.build_table(data)
        lengths = t.lengths[data].astype(np.int64)
        nchunks = -(-data.size // cs)
        bits = np.bincount(np.arange(data.size) // cs, lengths,
                           minlength=nchunks).astype(np.int64)
        sizes = hf._parse(buf)[4].astype(np.int64)
        if not (8 * sizes - bits >= t.lengths[5]).any():
            raise AssertionError(f"cs {cs}: no chunk's padding decodes")
        return buf, data, 0
    buf = container(data, cs)
    nchunks = -(-data.size // cs)
    if kind == "overrun middle":
        return overrun(buf, nchunks // 2), data, 1
    if kind == "overrun end":
        return overrun(buf, nchunks - 1), data, 1
    raise ValueError(f"unknown kind {kind!r}")


def decode_inputs(buf: bytes, device):
    """``decode_chunks``' arguments for a container, as
    ``huff_decompress`` uploads them."""
    n, cs, _, t, sizes, offsets = hf._parse(buf)
    return (hf.upload_bytes(np.frombuffer(buf, np.uint8), device),
            torch.from_numpy(offsets).to(device),
            torch.from_numpy(sizes.astype(np.int32)).to(device),
            *hf.decode_tables(t, device), cs, n)
