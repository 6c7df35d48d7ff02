"""The port's host library (``sprintz_tpu_torch/native_host.py`` over
``csrc/sprintz_host.cpp``) against its plain Python versions and against the
JAX package's own native and Python host functions: the header walk, the
payload gather, the emission plan, the stream assembly and the +Huf
histogram give identical widths, offsets, rows, dense payloads, plans and
bytes. Streams come from the port's compress on the CPU; no JAX compile."""

import numpy as np
import pytest
import torch

from sprintz_tpu import decoder as jdec
from sprintz_tpu import encoder as jenc
from sprintz_tpu import native_host as jnh
from sprintz_tpu import planner as jplanner
from sprintz_tpu_torch import decoder, encoder, native_host, planner
from sprintz_tpu_torch.constants import LOWDIM_MAX_NDIMS, METADATA_LEN_RLE
from sprintz_tpu_torch.entropy import huffman as hf
from sprintz_tpu_torch.ops.bitmath import header_value
from sprintz_tpu_torch.planner import EmissionPlan
from sprintz_tpu_torch.probes import unpack_cases as uc
from sprintz_tpu_torch.stream_format import read_metadata_rle

SHAPES = [(1, 1), (1, 2), (1, 3), (1, 4), (1, 5), (1, 8), (1, 13), (1, 64),
          (1, 129), (2, 1), (2, 2), (2, 3), (2, 7), (2, 40)]
DATA = ["walk", "constant", "runs", "random"]


def make_data(rng, elem_sz: int, ndims: int, kind: str, tail: bool):
    """A flat u8/u16 stream of about 4 KB (at least 21 rows). Without a
    tail it is whole groups (rows a multiple of 16); with one it has 5
    more rows and, where D > 1, part of a row, so its length is not a
    multiple of D."""
    nrows = max(4096 // (ndims * elem_sz), 21) // 16 * 16
    extra = (5 * ndims + (ndims + 1) // 2) if tail else 0
    n = nrows * ndims + extra
    top = 1 << (8 * elem_sz)
    if kind == "walk":
        x = np.cumsum(rng.integers(-6, 7, n)) % top
    elif kind == "constant":
        x = np.full(n, 77)
    elif kind == "runs":  # every other 40-row segment constant
        steps = rng.integers(-6, 7, (n + ndims - 1) // ndims)
        steps[np.arange(steps.size) // 40 % 2 == 0] = 0
        x = (np.cumsum(np.repeat(steps, ndims)[:n]) + 5) % top
    else:
        x = rng.integers(0, top, n)
    return x.astype(np.uint8 if elem_sz == 1 else np.uint16)


def as_lowdim(elem_sz: int, ndims: int) -> bool:
    return ndims <= LOWDIM_MAX_NDIMS[elem_sz]


def assert_index_equal(got, want, what):
    np.testing.assert_array_equal(got.widths, want.widths, err_msg=what)
    np.testing.assert_array_equal(got.payload_offsets, want.payload_offsets,
                                  err_msg=what)
    np.testing.assert_array_equal(got.out_rows, want.out_rows, err_msg=what)
    assert (got.total_rows, got.tail_offset) == (
        want.total_rows, want.tail_offset), what


def check_walk_and_gather(buf: bytes, ngroups: int, ndims: int, elem_sz: int,
                          lowdim: bool) -> np.ndarray:
    """Native walk and gather == the port's plain versions == the JAX
    package's Python walk, native walk and native gather; returns the
    dense payload."""
    nat = decoder.walk_headers(buf, ngroups, ndims, elem_sz, lowdim)
    py = decoder._walk_headers_py(buf, ngroups, ndims, elem_sz, lowdim)
    assert_index_equal(nat, py, "port plain walk")
    np.testing.assert_array_equal(nat.row_bytes, py.row_bytes)
    assert nat.widths.dtype == np.uint8 and nat.row_bytes.dtype == np.int32
    assert_index_equal(nat, jdec._walk_headers_py(
        buf, ngroups, ndims, elem_sz, lowdim=lowdim), "JAX Python walk")
    jw, jo, jr, jt, jtail = jnh.walk_headers_native(
        buf, METADATA_LEN_RLE, ngroups, ndims, elem_sz, lowdim)
    np.testing.assert_array_equal(nat.widths, jw)
    np.testing.assert_array_equal(nat.payload_offsets, jo)
    np.testing.assert_array_equal(nat.out_rows, jr)
    assert (nat.total_rows, nat.tail_offset) == (jt, jtail)

    dense = decoder.gather_payloads(buf, nat)
    np.testing.assert_array_equal(dense,
                                  decoder._gather_payloads_py(buf, py))
    want = np.empty_like(dense)
    if lowdim:
        assert dense.shape == (nat.widths.shape[0], ndims, 8 * elem_sz)
        assert jnh.gather_dims_native(buf, nat.payload_offsets, nat.widths,
                                      want)
    else:
        assert dense.shape[:2] == (nat.widths.shape[0], 8)
        assert jnh.gather_blocks_native(
            buf, nat.payload_offsets, nat.row_bytes.astype(np.int64), want)
    np.testing.assert_array_equal(dense, want)
    return dense


@pytest.mark.parametrize("tail", [False, True], ids=["no_tail", "tail"])
@pytest.mark.parametrize("kind", DATA)
@pytest.mark.parametrize("elem_sz,ndims", SHAPES)
def test_walk_and_gather_match(rng, elem_sz, ndims, kind, tail):
    x = make_data(rng, elem_sz, ndims, kind, tail)
    buf = encoder.compress(x, ndims, device="cpu")
    ngroups, _, _ = read_metadata_rle(buf)
    assert ngroups > 0
    lowdim = as_lowdim(elem_sz, ndims)
    check_walk_and_gather(buf, ngroups, ndims, elem_sz, lowdim)
    np.testing.assert_array_equal(
        decoder.decompress(buf, elem_sz=elem_sz, device="cpu"), x)


@pytest.mark.parametrize("tail", [False, True], ids=["no_tail", "tail"])
@pytest.mark.parametrize("kind", DATA)
@pytest.mark.parametrize("elem_sz,ndims", SHAPES)
def test_plan_and_assembly_match(rng, elem_sz, ndims, kind, tail):
    """The plan under both run comparators and the assembled bytes, with
    and without the device's width sums, against the port's plain versions
    and the JAX package's Python and native ones; with delta's comparator
    the bytes are compress's."""
    x = make_data(rng, elem_sz, ndims, kind, tail)
    lowdim = as_lowdim(elem_sz, ndims)
    nb = x.size // (8 * ndims)
    rows = encoder.upload_rows(x[:nb * 8 * ndims].reshape(-1, ndims),
                               torch.device("cpu"))
    widths, hdr, dense, ws = encoder.encode_device(rows, elem_sz, "delta",
                                                   lowdim)
    w_np, h_np = widths.to(torch.uint8).numpy(), hdr.to(torch.uint8).numpy()
    d_np, ws_np = dense.numpy(), ws.numpy()
    for eq in (False, True):
        plan = planner.build_plan(ws_np == 0, x.size, ndims, eq)
        for want in (planner._build_plan_py(ws_np == 0, x.size, ndims, eq),
                     jplanner._build_plan_py(ws_np == 0, x.size, ndims, eq)):
            np.testing.assert_array_equal(plan.kinds, want.kinds)
            np.testing.assert_array_equal(plan.values, want.values)
            assert (plan.ngroups, plan.consumed_blocks,
                    plan.remaining_elems) == (
                want.ngroups, want.consumed_blocks, want.remaining_elems)
        assert plan.kinds.dtype == np.int8 and plan.values.dtype == np.int32
        kinds, values, ngroups, consumed, remaining = jnh.build_plan_native(
            ws_np == 0, x.size, ndims, eq)
        np.testing.assert_array_equal(plan.kinds, kinds)
        np.testing.assert_array_equal(plan.values, values)
        assert (plan.ngroups, plan.consumed_blocks,
                plan.remaining_elems) == (ngroups, consumed, remaining)

        tail_x = x[x.size - plan.remaining_elems:]
        got = encoder.assemble_stream(plan, w_np, h_np, d_np, ndims, elem_sz,
                                      tail_x, lowdim, ws_np)
        assert got == encoder.assemble_stream(plan, w_np, h_np, d_np, ndims,
                                              elem_sz, tail_x, lowdim)
        assert got == encoder._assemble_stream_py(
            plan, w_np, h_np, d_np, ndims, elem_sz, tail_x, lowdim)
        assert got == jenc._assemble_stream_np(
            plan, w_np, h_np, d_np, ndims, elem_sz, lowdim, tail_x)
        assert got == jnh.assemble_stream_native(
            plan.kinds, plan.values, plan.ngroups, plan.remaining_elems,
            w_np.astype(np.int32), h_np, d_np, ndims, elem_sz, lowdim,
            tail_x.tobytes(), wsums=ws_np)
        if not eq:
            assert got == encoder.compress(x, ndims, device="cpu")


def case_stream(rng, eb: int, ndims: int, nb: int, kind: str):
    """A stream of a decode case's blocks: the case's widths and dense
    payload through the plan (all-zero blocks become runs) and the
    assembler; -> (stream, the data blocks' dense payload, lowdim)."""
    lowdim = ndims <= LOWDIM_MAX_NDIMS[eb // 8]
    if lowdim:
        dense, w, _ = uc.lowdim_case(rng, eb, ndims, nb, kind)
    else:
        dense, w, _ = uc.unpack_case(rng, eb, ndims, nb, kind)
    ws = w.astype(np.int32).sum(axis=1)
    plan = planner.build_plan(ws == 0, nb * 8 * ndims, ndims)
    hdr = header_value(torch.from_numpy(w), eb).numpy()
    tail = np.zeros(plan.remaining_elems, np.uint8 if eb == 8 else np.uint16)
    buf = encoder.assemble_stream(plan, w, hdr, dense, ndims, eb // 8, tail,
                                  lowdim, ws)
    data = plan.values[plan.kinds == planner.KIND_DATA]
    return buf, dense[data], lowdim


@pytest.mark.parametrize("case", uc.LOWDIM_CASES + [
    c for c in uc.UNPACK_CASES if c[3] != "narrow maxb"],
    ids=lambda c: f"{c[0]}b-d{c[1]}-nb{c[2]}-{c[3].replace(' ', '_')}")
def test_gather_at_decode_cases(rng, case):
    """The decode cases' payloads (every legal width, at u16 widths 9-14
    lowdim sections across two 64-bit words, all-zero blocks, rows wider
    than a tile) come back from the walk and the gather as packed."""
    eb, ndims, nb, kind = case
    buf, want, lowdim = case_stream(rng, eb, ndims, nb, kind)
    ngroups, _, _ = read_metadata_rle(buf)
    dense = check_walk_and_gather(buf, ngroups, ndims, eb // 8, lowdim)
    np.testing.assert_array_equal(dense, want[:, :, :dense.shape[2]])
    assert not want[:, :, dense.shape[2]:].any()


HISTOGRAM_INPUTS = {
    "empty": lambda rng: np.zeros(0, np.uint8),
    "one": lambda rng: np.array([200], np.uint8),
    "three": lambda rng: np.array([5, 5, 250], np.uint8),
    "every symbol": lambda rng: np.arange(256, dtype=np.uint8),
    "one symbol": lambda rng: np.full(10_001, 9, np.uint8),
    "random 4099": lambda rng: rng.integers(0, 256, 4099).astype(np.uint8),
    "skewed": lambda rng: np.minimum(rng.geometric(0.3, 65_537), 255).astype(
        np.uint8),
    "sprintz stream": lambda rng: np.frombuffer(encoder.compress(
        make_data(rng, 1, 64, "walk", True), 64, device="cpu"), np.uint8),
    # three pieces of the library's threads, the last one short
    "17 MiB": lambda rng: rng.integers(0, 256, (17 << 20) + 5).astype(
        np.uint8),
}


@pytest.mark.parametrize("what", list(HISTOGRAM_INPUTS))
def test_histogram_matches_bincount(rng, what):
    data = HISTOGRAM_INPUTS[what](rng)
    want = np.bincount(data, minlength=256)
    got = native_host.histogram(data)
    assert got.dtype == np.int64 and got.shape == (256,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native_host.histogram(data.tobytes()), want)
    np.testing.assert_array_equal(jnh.histogram_native(data), want)
    t = hf.build_table(data)
    np.testing.assert_array_equal(t.lengths, hf._limited_lengths(want))


@pytest.mark.parametrize("elem_sz,ndims,rows,kind",
                         [(1, 64, 1 << 16, "random"), (2, 2, 1 << 20, "walk")],
                         ids=["rowmajor", "lowdim"])
def test_threaded_paths_match(rng, elem_sz, ndims, rows, kind):
    """Streams large enough that the gather (2 MiB of output a thread) and
    the assembly (streams of 512 KB and more) split their work over
    threads; their outputs equal the plain versions'."""
    top = 1 << (8 * elem_sz)
    x = (rng.integers(0, top, rows * ndims) if kind == "random"
         else np.cumsum(rng.integers(-6, 7, rows * ndims)) % top)
    x = x.astype(np.uint8 if elem_sz == 1 else np.uint16)
    lowdim = as_lowdim(elem_sz, ndims)
    rows_t = encoder.upload_rows(x.reshape(-1, ndims), torch.device("cpu"))
    widths, hdr, dense, ws = encoder.encode_device(rows_t, elem_sz, "delta",
                                                   lowdim)
    w_np, h_np = widths.to(torch.uint8).numpy(), hdr.to(torch.uint8).numpy()
    d_np, ws_np = dense.numpy(), ws.numpy()
    plan = planner.build_plan(ws_np == 0, x.size, ndims)
    tail = x[x.size - plan.remaining_elems:]
    buf = encoder.assemble_stream(plan, w_np, h_np, d_np, ndims, elem_sz,
                                  tail, lowdim, ws_np)
    assert len(buf) >= 1 << 19
    assert buf == encoder._assemble_stream_py(plan, w_np, h_np, d_np, ndims,
                                              elem_sz, tail, lowdim)
    ngroups, _, _ = read_metadata_rle(buf)
    got = check_walk_and_gather(buf, ngroups, ndims, elem_sz, lowdim)
    assert got.nbytes >= 2 * (2 << 20)


def test_entry_points_count_their_calls(rng):
    """Each wrapper counts its calls into the library, on every path that
    reaches it: delta and xff, both layouts, +Huf."""
    for fn in native_host.ENTRY_POINTS:
        fn.calls = 0
    for es, nd in ((1, 9), (1, 3)):
        x = make_data(rng, es, nd, "walk", True)
        for codec in ("delta", "xff"):
            buf = encoder.compress(x[:64 * nd], nd, codec=codec, device="cpu")
            decoder.decompress(buf, codec=codec, elem_sz=es, device="cpu")
    hf.build_table(x)
    assert {fn.__name__: fn.calls for fn in native_host.ENTRY_POINTS} == {
        "walk_headers": 4, "walk_headers_parallel": 0, "gather_blocks": 2,
        "gather_dims": 2, "build_plan": 4, "assemble_stream": 4,
        "histogram": 1}


def test_assembler_takes_an_empty_plan():
    """A stream of at least MIN_DATA_SIZE elements that is shorter than a
    group is all tail: an empty plan (the JAX package's numpy assembler
    cannot reshape it; its native one answers first)."""
    plan = EmissionPlan(kinds=np.zeros(0, np.int8),
                        values=np.zeros(0, np.int32), ngroups=0,
                        consumed_blocks=0, remaining_elems=130)
    tail = np.arange(130, dtype=np.uint16)
    args = (plan, np.zeros((0, 5), np.uint8), np.zeros((0, 5), np.uint8),
            np.zeros((0, 8, 10), np.uint8), 5, 2, tail)
    got = encoder.assemble_stream(*args)
    assert got == encoder._assemble_stream_py(*args)
    assert got == bytes([0, 0, 0, 0, 130, 0, 5, 0]) + tail.tobytes()
