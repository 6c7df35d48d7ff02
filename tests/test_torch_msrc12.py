"""The port's main path at the MSRC-12 deployment's shape (u8, D 80, delta +
RLE in the row-major layout) against the benchmark's frozen reference
(``portbench/reference``, plain NumPy), on the CPU: ``compress`` writes the
reference's stream byte for byte, ``decompress`` gives back the input, and
the reference reads the port's stream back as well. Cases: the
benchmark's ``msrc12_like`` profile; constant stretches (run blocks, one
past the 1-byte run varint); full-range noise (width-8 blocks, the widest
dense payload); a length with a verbatim tail of fewer than 8 rows. And the
counters the benchmark reads there: the gather's and the join's ``bytes``
over one call."""

import numpy as np
import pytest

from portbench import gen, reference
from sprintz_tpu_torch import SprintzCodec, decoder
from sprintz_tpu_torch.stream_format import read_metadata_rle
from sprintz_tpu_torch.utils import trace

NDIMS = 80
KINDS = ["msrc12", "runs", "noise", "tail"]


def make(kind: str, seed: int) -> np.ndarray:
    """(rows, 80) u8 of one case."""
    if kind == "noise":
        rng = np.random.default_rng(seed)
        return rng.integers(0, 256, (2048, NDIMS), dtype=np.uint8)
    rows = {"msrc12": 3000, "runs": 4000, "tail": 2003}[kind]
    x = gen.synthetic("msrc12_like", rows, np.uint8, [seed, 0, 0])
    if kind == "runs":
        x[600:680] = x[599]  # 10 blocks: a 1-byte run varint
        x[1000:3500] = x[999]  # 312 blocks: past it, 2 bytes
    return x


def walk(buf: bytes):
    ngroups, remaining, ndims = read_metadata_rle(buf)
    return decoder.walk_headers(buf, ngroups, ndims, 1, False), remaining


@pytest.mark.parametrize("seed", [3, 2147483659])
@pytest.mark.parametrize("kind", KINDS)
def test_port_writes_and_reads_the_reference_stream(kind, seed):
    x = make(kind, seed)
    codec = SprintzCodec("delta", 1, device="cpu")
    buf = codec.compress(x)
    assert buf == reference.encode(x, "delta")
    assert np.array_equal(codec.decompress(buf), x.reshape(-1))
    assert np.array_equal(reference.decode(buf, "delta", 1), x.reshape(-1))
    idx, remaining = walk(buf)
    if kind == "runs":
        assert idx.total_rows > idx.widths.shape[0] * 8  # run blocks
    if kind == "noise":
        assert decoder.stream_maxb(idx) == NDIMS  # 80 fields of 8 bits
    if kind == "tail":
        assert 0 < remaining < 8 * NDIMS


@pytest.mark.parametrize("kind", KINDS)
def test_gather_and_join_count_their_bytes(kind):
    x = make(kind, 11)
    codec = SprintzCodec("delta", 1, device="cpu")
    buf = codec.compress(x)
    before = trace.counters()
    out = codec.decompress(buf)
    after = trace.counters()
    dense = decoder.gather_payloads(buf, walk(buf)[0])
    assert out.nbytes == x.nbytes
    assert after["decoder._join.bytes"] - before["decoder._join.bytes"] == (
        out.nbytes)
    assert (after["decoder.gather_payloads.bytes"]
            - before["decoder.gather_payloads.bytes"]) == dense.nbytes
