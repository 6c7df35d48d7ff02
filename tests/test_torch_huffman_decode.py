"""K6's plain version (``decode_chunks_plain``) against the JAX package on
the decode side's edge cases (``sprintz_tpu_torch/probes/decode_cases.py``,
the list ``chip_smoke.py`` holds the kernel to on the card): symbols equal
the numpy decoder's on valid containers, an overrun chunk raises where the
native decoder raises, and at chunk sizes 8 and 16 the symbols equal the
Pallas kernel's in interpret mode. Every comparison is exact."""

import numpy as np
import pytest
import torch

import sprintz_tpu.entropy.huffman as jhf
from sprintz_tpu import native_host
from sprintz_tpu.entropy import pallas_huffman as jph
from sprintz_tpu.errors import CorruptStreamError as JaxCorruptStreamError
from sprintz_tpu_torch.entropy import huffman as hf
from sprintz_tpu_torch.errors import CorruptStreamError
from sprintz_tpu_torch.ops import huffman_kernels as hk
from sprintz_tpu_torch.probes import decode_cases as dc


def plain_decode(buf: bytes):
    """(symbols, flagged chunks) of K6's plain version on a container."""
    n = hf._parse(buf)[0]
    out = hk.decode_chunks(*dc.decode_inputs(buf, torch.device("cpu")))
    syms, nbad = hk.split_decoded(out, n)
    return syms.numpy(), int(nbad)


@pytest.mark.parametrize("cs,kind", dc.DECODE_CASES)
def test_decode_case_matches_jax(cs, kind):
    rng = np.random.default_rng(cs * 31 + dc.DECODE_KINDS.index(kind))
    buf, data, nbad = dc.decode_case(rng, cs, kind)
    syms, got_bad = plain_decode(buf)
    assert got_bad == nbad
    if nbad == 0:
        np.testing.assert_array_equal(syms, data)
        np.testing.assert_array_equal(
            syms, jhf.huff_decompress(buf, backend="numpy"))
        np.testing.assert_array_equal(hf.huff_decompress(buf, device="cpu"),
                                      data)
        return
    with pytest.raises(CorruptStreamError, match="overran"):
        hf.huff_decompress(buf, device="cpu")
    if native_host.get_lib() is not None:
        with pytest.raises(JaxCorruptStreamError, match="overran"):
            jhf.huff_decompress(buf, backend="native")


def pallas_case(rng, n: int, kind: str):
    """(symbols, table or None) of a decode kind at n symbols."""
    if kind == "12-bit codes":
        t12 = dc.ec.twelve_bit_table()
        long_ = np.flatnonzero(t12.lengths == 12).astype(np.uint8)
        return long_[rng.integers(0, long_.size, n)], t12
    if kind == "one symbol":
        return np.full(n, 42, np.uint8), None
    return rng.choice(np.array([5, 77, 200], np.uint8), n,
                      p=[0.6, 0.2, 0.2]), None  # "padding"


@pytest.mark.parametrize("cs,kind", [(8, "padding"), (8, "one symbol"),
                                     (16, "12-bit codes")])
def test_decode_cases_match_pallas_interpret(cs, kind):
    """Kinds that ``test_torch_huffman.py``'s interpret-mode case does not
    reach, at a chunk count that the Pallas kernel's 1024-chunk lane tile
    takes (1023 chunks and a part). One compile a case: the cost."""
    rng = np.random.default_rng(cs)
    data, t = pallas_case(rng, cs * 1023 + cs // 2 + 1, kind)
    buf = dc.container(data, cs, t)
    words, tables, cs2, nchunks, n = jhf.device_decode_prep(buf)
    assert jph.decode_pallas_available(words.shape[1], cs2)
    want = jph.decode_jax_pallas(words, tables, cs2, nchunks, n,
                                 interpret=True, fuse_perm=True)
    syms, nbad = plain_decode(buf)
    np.testing.assert_array_equal(syms, want)
    np.testing.assert_array_equal(syms, data)
    assert nbad == 0
