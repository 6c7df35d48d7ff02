"""Faults of the port against the JAX package, each pinned by a CPU test
that compares with the JAX package's own behaviour: a short stream whose
metadata declares 0 dims, ``SprintzCodec``'s positional fields, and a +Huf
chunk whose codes run past its payload."""

import numpy as np
import pytest
import torch

import sprintz_tpu
import sprintz_tpu.entropy.huffman as jhf
from sprintz_tpu import native_host
from sprintz_tpu.errors import CorruptStreamError as JaxCorruptStreamError
import sprintz_tpu_torch
from sprintz_tpu_torch.entropy import huffman as hf
from sprintz_tpu_torch.errors import CorruptStreamError
from sprintz_tpu_torch.ops import huffman_kernels as hk
from sprintz_tpu_torch.probes import decode_cases as dc


def test_zero_dims_metadata_raises_like_jax():
    """A verbatim stream (18 bytes for 10 u8 values) whose ndims bytes
    are zeroed: both packages raise; the empty stream still decodes."""
    buf = bytearray(sprintz_tpu.SprintzCodec().compress(
        np.arange(10, dtype=np.uint8)))
    assert sprintz_tpu_torch.SprintzCodec(device="cpu").compress(
        np.arange(10, dtype=np.uint8)) == bytes(buf)
    buf[6:8] = b"\0\0"
    with pytest.raises(CorruptStreamError, match="0 dims"):
        sprintz_tpu_torch.SprintzCodec(device="cpu").decompress(bytes(buf))
    with pytest.raises(JaxCorruptStreamError, match="0 dims"):
        sprintz_tpu.SprintzCodec().decompress(bytes(buf))
    empty = sprintz_tpu.SprintzCodec().compress(np.zeros(0, np.uint8))
    assert sprintz_tpu_torch.SprintzCodec(device="cpu").compress(
        np.zeros(0, np.uint8)) == empty
    for got in (sprintz_tpu_torch.SprintzCodec(device="cpu").decompress(empty),
                sprintz_tpu.SprintzCodec().decompress(empty)):
        assert got.size == 0


def test_codec_entropy_and_device_are_keyword_only(rng):
    """JAX's third positional field is ``backend``: the port refuses a
    third positional argument, and by keyword its +Huf bytes equal
    JAX's."""
    with pytest.raises(TypeError):
        sprintz_tpu_torch.SprintzCodec("xff", 2, "huffman")
    x = (np.cumsum(rng.integers(-30, 31, (300, 5)), axis=0) % 65536
         ).astype(np.uint16)
    got = sprintz_tpu_torch.SprintzCodec(
        "xff", 2, entropy="huffman", device="cpu").compress(x)
    assert got == sprintz_tpu.SprintzCodec("xff", 2,
                                           entropy="huffman").compress(x)


def skewed_container(rng, n: int, cs: int) -> bytes:
    data = np.minimum(rng.geometric(0.35, n) - 1, 255).astype(np.uint8)
    return dc.container(data, cs)


@pytest.mark.parametrize("where", ["last", "middle"])
def test_huffman_overrun_raises_like_native(where):
    """434 skewed symbols at cs 128 (4 chunks, the last partial): a chunk
    whose size is lowered by one, with its last byte dropped. The port
    raises, as JAX's native decoder does; the valid container, whose last
    chunk is partial, is not flagged."""
    buf = skewed_container(np.random.default_rng(5), 434, 128)
    n, _, nchunks, _, _, _ = hf._parse(buf)
    assert nchunks == 4 and n % 128
    np.testing.assert_array_equal(hf.huff_decompress(buf, device="cpu"),
                                  jhf.huff_decompress(buf, backend="numpy"))
    bad = dc.overrun(buf, nchunks - 1 if where == "last" else 1)
    assert len(bad) == len(buf) - 1
    with pytest.raises(CorruptStreamError, match="overran its chunk"):
        hf.huff_decompress(bad, device="cpu")
    if native_host.get_lib() is not None:
        with pytest.raises(JaxCorruptStreamError, match="overran its chunk"):
            jhf.huff_decompress(bad, backend="native")
    out = hk.decode_chunks(*dc.decode_inputs(bad, torch.device("cpu")))
    assert int(hk.split_decoded(out, n)[1]) == 1
