"""The pieces of the port's sidecar path, each against its plain version and
the JAX package: the group index the assembler gives (against
``checkpoint._group_index_py`` and the JAX package's ``_group_index``), the
parallel header walk in the host library (against
``decoder._walk_headers_parallel_py``, the serial walk and the JAX
package's ``walk_headers_parallel``, and its refusal of a sidecar of
another stream), FIRE's encode with its states (against
``fire_encode_with_states``), and the plain versions of the chunked FIRE
decode and of the delta chunk seed (against the JAX package's
``fire_decode(init_state=)`` vmapped over chunks as its
``_decode_pass_chunks`` runs it, and its delta arithmetic there) at chunk
counts 1, 2, 7 and 33, of unequal lengths. The host-built kernels are
held to these plain versions by ``test_torch_host_fire.py``,
``test_torch_host_decode.py`` and ``test_torch_chunk_decode.py``."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sprintz_tpu import checkpoint as jc
from sprintz_tpu import decoder as jdec
from sprintz_tpu.models import forecasters as jf
from sprintz_tpu_torch import checkpoint as pc
from sprintz_tpu_torch import decoder, encoder, native_host
from sprintz_tpu_torch.constants import LOWDIM_MAX_NDIMS
from sprintz_tpu_torch.errors import CorruptStreamError
from sprintz_tpu_torch.models import forecasters as fc
from sprintz_tpu_torch.ops import decode_kernels as dk
from sprintz_tpu_torch.probes.host_build import chunk_cuts
from sprintz_tpu_torch.stream_format import read_metadata_rle

from test_torch_native_host import assert_index_equal, make_data

STREAMS = [(es, nd, kind) for es, nd in ((1, 1), (1, 3), (1, 9), (2, 2),
                                         (2, 40)) for kind in ("walk", "runs")]


@functools.cache
def stream_of(es: int, nd: int, kind: str, codec: str = "delta"):
    rng = np.random.default_rng([es, nd, len(kind)])
    x = make_data(rng, es, nd, kind, True)
    x = np.concatenate([x] * 4)  # about 16 KB: dozens of groups
    return x, *encoder.compress_with_layout(x, nd, codec=codec, device="cpu")


@pytest.mark.parametrize("es,nd,kind", STREAMS)
def test_group_index_equals_python_and_jax(es, nd, kind):
    x, buf, layout = stream_of(es, nd, kind)
    ngroups, _, _ = read_metadata_rle(buf)
    lowdim = nd <= LOWDIM_MAX_NDIMS[es]
    offs, rows, blocks, total = pc._group_index_py(buf, ngroups, nd, es,
                                                   lowdim)
    np.testing.assert_array_equal(layout.group_offsets, offs)
    np.testing.assert_array_equal(layout.group_first_rows, rows)
    np.testing.assert_array_equal(rows // 8, blocks)
    j = jc._group_index(buf, ngroups, nd, es, lowdim)
    np.testing.assert_array_equal(offs, j.group_offsets)
    np.testing.assert_array_equal(rows, j.first_row_of_group)
    np.testing.assert_array_equal(blocks, j.first_block_of_group)
    assert total == j.total_rows == decoder.walk_headers(
        buf, ngroups, nd, es, lowdim).total_rows


@pytest.mark.parametrize("every", [1, 3, 16])
@pytest.mark.parametrize("es,nd,kind", STREAMS[::3])
def test_parallel_walk_equals_serial_python_and_jax(es, nd, kind, every):
    x, buf, layout = stream_of(es, nd, kind)
    ngroups, _, _ = read_metadata_rle(buf)
    lowdim = nd <= LOWDIM_MAX_NDIMS[es]
    ck = np.arange(0, ngroups, every)
    bo, ro = layout.group_offsets[ck], layout.group_first_rows[ck]
    native_host.walk_headers_parallel.calls = 0
    got = decoder.walk_headers_parallel(buf, ngroups, nd, es, bo, ro, every,
                                        lowdim)
    assert native_host.walk_headers_parallel.calls == (ngroups > every)
    serial = decoder.walk_headers(buf, ngroups, nd, es, lowdim)
    assert_index_equal(got, serial, "serial walk")
    np.testing.assert_array_equal(got.row_bytes, serial.row_bytes)
    py = decoder._walk_headers_parallel_py(buf, ngroups, nd, es, bo, ro,
                                           every, lowdim)
    assert_index_equal(got, py, "plain parallel walk")
    np.testing.assert_array_equal(got.row_bytes, py.row_bytes)
    assert_index_equal(got, jdec.walk_headers_parallel(
        buf, ngroups, nd, es, bo, ro, every, lowdim=lowdim), "JAX walk")


def test_parallel_walk_on_threads_equals_serial():
    """A stream of about 20 MB, which the host library walks on more than
    one thread (a thread takes 8 MiB of stream at least), with runs, so
    that segments leave gaps the walk closes."""
    rng = np.random.default_rng(17)
    x = rng.integers(0, 256, (320000, 64)).astype(np.uint8)
    x[(np.arange(x.shape[0]) // 24) % 5 == 0] = 7  # runs of constant rows
    buf, layout = encoder.compress_with_layout(x.reshape(-1), 64,
                                               device="cpu")
    ngroups, _, _ = read_metadata_rle(buf)
    assert len(buf) > 16 << 20
    bo, ro = layout.group_offsets[::16], layout.group_first_rows[::16]
    got = decoder.walk_headers_parallel(buf, ngroups, 64, 1, bo, ro, 16)
    serial = decoder.walk_headers(buf, ngroups, 64, 1)
    assert got.widths.shape[0] < 2 * ngroups  # the runs left gaps
    assert_index_equal(got, serial, "serial walk")
    np.testing.assert_array_equal(got.row_bytes, serial.row_bytes)
    assert_index_equal(got, jdec.walk_headers_parallel(
        buf, ngroups, 64, 1, bo, ro, 16), "JAX walk")


def test_parallel_walk_refuses_a_sidecar_of_another_stream():
    x, buf, layout = stream_of(1, 9, "runs")
    ngroups, _, _ = read_metadata_rle(buf)
    ck = np.arange(0, ngroups, 4)
    bo, ro = layout.group_offsets[ck], layout.group_first_rows[ck].copy()
    for walk in (decoder.walk_headers_parallel,
                 decoder._walk_headers_parallel_py):
        bad = ro.copy()
        bad[2] += 8  # a segment's rows no longer end at the next one's
        with pytest.raises(CorruptStreamError, match="row"):
            walk(buf, ngroups, 9, 1, bo, bad, 4)
        with pytest.raises(CorruptStreamError):  # a walk past the buffer
            walk(buf[: bo[-1] + 3], ngroups, 9, 1, bo, ro, 4)
    with pytest.raises(CorruptStreamError):  # an offset outside the stream
        decoder.walk_headers_parallel(buf, ngroups, 9, 1, bo + len(buf), ro, 4)


@pytest.mark.parametrize("eb,trunc,nd", [(8, True, 9), (16, True, 5),
                                         (8, False, 3), (16, False, 2)])
def test_fire_encode_states_equal_jax(eb, trunc, nd):
    rng = np.random.default_rng(eb + nd)
    x = (np.cumsum(rng.integers(-40, 41, (8 * 30, nd)), 0) % (1 << eb)
         ).astype(np.int32)
    errs, states = fc.fire_encode(torch.from_numpy(x), eb, trunc,
                                  states=True)
    jerrs, jstates = jf.fire_encode_with_states(jnp.asarray(x), eb, trunc)
    np.testing.assert_array_equal(errs.numpy(), np.asarray(jerrs))
    np.testing.assert_array_equal(states.numpy(), np.asarray(jstates))
    assert states.dtype == torch.int32


@functools.cache
def jax_chunk_decoder(eb: int, trunc: bool):
    """FIRE decode vmapped over chunks, each from its own (3, D) state: the
    JAX package's ``_decode_pass_chunks`` on its errors."""
    def one(errs, state):
        return jf.fire_decode(errs, eb, trunc,
                              init_state=(state[0], state[1], state[2]))
    return jax.jit(jax.vmap(one))


def chunk_case(seed: int, eb: int, nd: int, nb: int, nchunks: int):
    """Errors of a stream, chunk cuts of unequal lengths, and states: the
    encoder's at the cuts, one replaced by random ones."""
    rng = np.random.default_rng(seed)
    half = 1 << (eb - 1)
    x = (np.cumsum(rng.integers(-50, 51, (nb * 8, nd)), 0) % (2 * half)
         ).astype(np.int32)
    return rng, x, chunk_cuts(rng, nb, nchunks)


@pytest.mark.parametrize("nchunks,eb,trunc,nd,nb", [
    (1, 8, True, 9, 20), (2, 16, True, 5, 20), (7, 8, False, 3, 30),
    (33, 16, False, 2, 40)])
def test_fire_decode_chunks_plain_equals_jax(nchunks, eb, trunc, nd, nb):
    rng, x, first = chunk_case(nchunks, eb, nd, nb, nchunks)
    errs, carries = fc.fire_encode(torch.from_numpy(x), eb, trunc,
                                   states=True)
    states = carries[torch.from_numpy(np.minimum(first[:-1], nb - 1))]
    states[torch.from_numpy(first[:-1] == nb)] = 0
    k = nchunks // 2
    states[k] = torch.from_numpy(np.stack([
        rng.integers(0, 1 << eb, nd), rng.integers(-3000, 3000, nd),
        rng.integers(-(1 << 15), 1 << 15, nd)]).astype(np.int32))
    zz = errs.to(torch.uint8) if eb == 8 else errs
    got = dk.widen(fc.fire_decode_chunks(zz, eb, first, states, trunc))
    # JAX: every chunk padded with zero errors to the longest, as the
    # vmapped pass pads them
    lens = np.diff(first)
    longest = max(int(lens.max()), 1) * 8
    pad = np.zeros((nchunks, longest, nd), np.int32)
    for c in range(nchunks):
        pad[c, : lens[c] * 8] = errs.numpy()[first[c] * 8: first[c + 1] * 8]
    want = np.asarray(jax_chunk_decoder(eb, trunc)(
        jnp.asarray(pad), jnp.asarray(states.numpy())))
    want = np.concatenate([want[c, : lens[c] * 8] for c in range(nchunks)])
    np.testing.assert_array_equal(got.numpy(), want)
    if k == 0 or nchunks == 1:
        return
    np.testing.assert_array_equal(got.numpy()[: first[k] * 8],
                                  x[: first[k] * 8])


@pytest.mark.parametrize("nchunks,eb,nd,nb", [(1, 8, 9, 20), (2, 16, 3, 20),
                                              (7, 8, 1, 30),
                                              (33, 16, 40, 40)])
def test_delta_chunk_seed_plain_equals_jax(nchunks, eb, nd, nb):
    """Each chunk's values are its state plus its own prefix, mod 2^eb: the
    JAX package's delta arithmetic in ``_decode_pass_chunks`` on the
    chunk's errors, here from the whole timeline's values."""
    rng, x, first = chunk_case(nchunks + 100, eb, nd, nb, nchunks)
    zz = fc.delta_encode(torch.from_numpy(x), eb)
    vals = dk.narrow(fc.delta_decode(zz, eb), eb)
    rows = first * 8
    states = rng.integers(-(1 << 20), 1 << 20, (nchunks, nd)).astype(np.int32)
    got = dk.widen(dk.delta_chunk_seed_plain(vals, rows, states, eb)).numpy()
    for c in range(nchunks):
        chunk = jnp.asarray(zz.numpy()[rows[c]: rows[c + 1]])
        want = (jf.delta_decode(chunk, eb) + states[c][None, :]) & (
            (1 << eb) - 1)
        np.testing.assert_array_equal(got[rows[c]: rows[c + 1]],
                                      np.asarray(want))
    same = np.where((rows[:-1] > 0)[:, None], x[np.maximum(rows[:-1] - 1, 0)],
                    0).astype(np.int32)
    np.testing.assert_array_equal(
        dk.widen(dk.delta_chunk_seed_plain(vals, rows, same, eb)).numpy(), x)


def test_chunk_wrappers_check_their_bounds():
    errs = torch.zeros((80, 3), dtype=torch.uint8)
    st = np.zeros((2, 3, 3), np.int32)
    for first in ([0, 5, 9], [1, 5, 10], [0, 7, 5, 10]):
        with pytest.raises(ValueError, match="chunk_first_block"):
            fc.fire_decode_chunks(errs, 8, first, st[: len(first) - 1])
    with pytest.raises(ValueError, match="states"):
        fc.fire_decode_chunks(errs, 8, [0, 5, 10], st[:1])
    cpu = torch.device("cpu")
    for first in ([0, 5, 9], [1, 5, 10], [0, 7, 5, 10]):
        with pytest.raises(ValueError, match="chunk_first_block"):
            dk.delta_chunks(first, np.zeros((len(first) - 1, 3), np.int32), 10,
                            3, cpu)
    with pytest.raises(ValueError, match="states"):
        dk.delta_chunks([0, 5, 10], np.zeros((1, 3), np.int32), 10, 3, cpu)
    dense = torch.zeros((10, 8, 3), dtype=torch.uint8)
    widths = torch.zeros((10, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="chunks"):  # chunks of another decode
        dk.decode_delta_contiguous(dense[:9], widths[:9], 8, dk.delta_chunks(
            [0, 5, 10], np.zeros((2, 3), np.int32), 10, 3, cpu))
    vals = torch.zeros((80, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="chunk_first_row"):
        dk.delta_chunk_seed_plain(vals, [0, 40, 79],
                                  np.zeros((2, 3), np.int32), 8)
