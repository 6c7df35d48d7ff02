"""The port's own spans and counters (``sprintz_tpu_torch.utils.trace``),
on the CPU.

Spans: under ``device_profile(device="cpu")`` each entry point's spans come
in the order of its stages, nested inside its ``sprintz.*`` span, for delta
and xff in both layouts (row-major u8 D 8, lowdim u8 D 2), for
``compress``, ``decompress``, the batches and a sidecar decode. With no
profiler running no span enters ``record_function``: every entry point
runs with it made to raise. Counters: a walk's data and run blocks add up
to its blocks, a gather counts the bytes it wrote, transfers count nothing
off CUDA, the host library counts the threads ``parallel_for`` starts, and
a counter lands on its function under a caller's wrapper."""

import functools
import os
import tempfile

import numpy as np
import pytest
import torch

import sprintz_tpu_torch as st
from sprintz_tpu_torch import checkpoint, decoder, native_host, simple
from sprintz_tpu_torch.stream_format import read_metadata_rle
from sprintz_tpu_torch.query import Operation, QueryParams, query
from sprintz_tpu_torch.utils import trace

LAYOUTS = {"rowmajor": 8, "lowdim": 2}  # u8 ndims of each layout
CASES = [(codec, layout) for codec in ("delta", "xff") for layout in LAYOUTS]
NROWS = 512

ENCODE = ["encode.upload", "encode.device", "encode.download", "encode.plan",
          "encode.assemble"]
DECODE = ["decode.walk", "decode.gather", "decode.upload", "decode.device",
          "decode.download", "decode.join"]
PREFIXES = ("sprintz.", "encode.", "decode.", "huf.")


def rows(ndims: int, seed: int = 0) -> np.ndarray:
    """u8 rows whose first half moves (data blocks) and second half holds
    still (run blocks)."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(-3, 4, (NROWS, ndims))
    steps[NROWS // 2:] = 0
    return (np.cumsum(steps, axis=0) + 128).astype(np.uint8)


def spans(fn, prefixes=PREFIXES):
    """``fn()`` under ``device_profile(device="cpu")`` -> its result and
    the program's spans, [(name, start ns, end ns)] in the order they
    opened."""
    with tempfile.TemporaryDirectory() as logdir, trace.device_profile(
            logdir, device="cpu") as prof:
        out = fn()
    got = sorted((e.start_ns(), e.end_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.is_user_annotation() and e.name().startswith(prefixes))
    return out, [(n, a, b) for a, b, n in got]


def nested(got):
    """The spans after the first lie inside it, one after another."""
    (_, lo, hi), rest = got[0], got[1:]
    assert all(lo <= a <= b <= hi for _, a, b in rest)
    assert all(rest[i][2] <= rest[i + 1][1] for i in range(len(rest) - 1))


@pytest.mark.parametrize("codec,layout", CASES)
def test_compress_and_decompress_spans(codec, layout):
    codec_ = st.SprintzCodec(codec, 1, device="cpu")
    x = rows(LAYOUTS[layout])
    buf, enc = spans(lambda: codec_.compress(x))
    out, dec = spans(lambda: codec_.decompress(buf))
    assert np.array_equal(out, x.reshape(-1))
    assert [n for n, _, _ in enc] == ["sprintz.compress"] + ENCODE
    assert [n for n, _, _ in dec] == ["sprintz.decompress"] + DECODE
    nested(enc)
    nested(dec)


@pytest.mark.parametrize("codec,layout", CASES)
def test_batch_spans(codec, layout):
    codec_ = st.SprintzCodec(codec, 1, device="cpu")
    xs = [rows(LAYOUTS[layout], seed) for seed in range(3)]
    bufs, enc = spans(lambda: codec_.compress_batch(xs))
    outs, dec = spans(lambda: codec_.decompress_batch(bufs))
    for x, out in zip(xs, outs):
        assert np.array_equal(out, x.reshape(-1))
    assert [n for n, _, _ in enc] == (
        ["sprintz.compress_batch"] + ENCODE[:3]
        + ["encode.plan", "encode.assemble"] * 3)
    assert [n for n, _, _ in dec] == (
        ["sprintz.decompress_batch"] + ["decode.walk"] * 3
        + ["decode.gather"] * 3 + ["decode.upload", "decode.device",
                                   "decode.download"]
        + ["decode.join"] * 3)
    nested(enc)
    nested(dec)


@pytest.mark.parametrize("codec,layout", CASES)
def test_sidecar_decode_spans(codec, layout):
    codec_ = st.SprintzCodec(codec, 1, device="cpu")
    x = rows(LAYOUTS[layout])
    (buf, sc), enc = spans(lambda: codec_.compress_seekable(
        x, every_groups=4))
    assert len(sc.byte_offsets) > 1  # the walk splits at the checkpoints
    out, dec = spans(lambda: codec_.decompress(buf, sidecar=sc))
    assert np.array_equal(out, x.reshape(-1))
    assert [n for n, _, _ in enc] == ["sprintz.compress_seekable"] + ENCODE
    assert [n for n, _, _ in dec] == ["sprintz.decompress"] + DECODE
    nested(enc)
    nested(dec)


def test_huffman_spans():
    codec_ = st.SprintzCodec("delta", 1, entropy="huffman", device="cpu")
    steps = np.random.default_rng(1).choice([-1, 0, 1], (4096, 8),
                                            p=[0.1, 0.8, 0.1])
    x = (np.cumsum(steps, axis=0) + 128).astype(np.uint8)  # +Huf shrinks it
    buf, enc = spans(lambda: codec_.compress(x))
    out, dec = spans(lambda: codec_.decompress(buf))
    assert np.array_equal(out, x.reshape(-1))
    assert [n for n, _, _ in enc] == ["sprintz.compress"] + ENCODE + [
        "huf.compress"]
    assert [n for n, _, _ in dec] == ["sprintz.decompress", "huf.decompress"
                                      ] + DECODE


def test_call_numbers_count():
    """A decorated entry point counts its calls whether traced or not."""
    codec_ = st.SprintzCodec("delta", 1, device="cpu")
    before = trace.counters()
    for _ in range(3):
        codec_.compress(rows(8))
    after = trace.counters()
    key = "api.SprintzCodec.compress.calls"
    assert after[key] - before[key] == 3
    assert after["encoder.encode_device.calls"] - before[
        "encoder.encode_device.calls"] == 3


def test_no_profiler_no_record_function(monkeypatch):
    """Without a profiler the spans enter nothing: every entry point runs
    with ``record_function`` made to raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for codec in ("delta", "xff"):
        for ndims in LAYOUTS.values():
            x = rows(ndims)
            for entropy in ("none", "huffman"):
                c = st.SprintzCodec(codec, 1, entropy=entropy, device="cpu")
                buf = c.compress(x)
                assert np.array_equal(c.decompress(buf), x.reshape(-1))
                bufs = c.compress_batch([x, x])
                assert all(np.array_equal(o, x.reshape(-1))
                           for o in c.decompress_batch(bufs))
                buf, sc = c.compress_seekable(x, every_groups=4)
                assert np.array_equal(c.decompress(buf, sidecar=sc),
                                      x.reshape(-1))
            plain = st.SprintzCodec(codec, 1, device="cpu")
            buf, sc = plain.compress_seekable(x, every_groups=4)
            assert np.array_equal(
                checkpoint.decode_range(buf, sc, 70, 100, device="cpu"),
                x[70:170])
            assert st.decompress(st.compress(x, codec, device="cpu"), codec,
                                 device="cpu").size == x.size
            got = query(st.compress(x, codec, device="cpu"),
                        QueryParams(Operation.REDUCE_SUM, False), codec,
                        elem_sz=1, device="cpu")
            assert got is not None
        sbuf = simple.compress_simple(rows(8).reshape(-1), 8, codec,
                                      device="cpu")
        assert np.array_equal(
            simple.decompress_simple(sbuf, codec, device="cpu"),
            rows(8).reshape(-1))


def delta(before: dict, after: dict, key: str) -> int:
    return after[key] - before.get(key, 0)


@pytest.mark.parametrize("codec,layout", CASES)
def test_walk_and_gather_counters(codec, layout):
    x = rows(LAYOUTS[layout])
    buf = st.compress(x, codec, device="cpu")
    before = trace.counters()
    out = st.decompress(buf, codec, device="cpu")
    after = trace.counters()
    assert np.array_equal(out, x.reshape(-1))
    data = delta(before, after, "decoder.walk_headers.data_blocks")
    runs = delta(before, after, "decoder.walk_headers.run_blocks")
    assert data > 0 and runs > 0
    ngroups, _, ndims = read_metadata_rle(buf)
    idx = decoder.walk_headers(buf, ngroups, ndims, 1, layout == "lowdim")
    assert data + runs == idx.total_rows // 8
    assert data == idx.widths.shape[0]
    dense = decoder.gather_payloads(buf, idx)
    assert delta(before, after, "decoder.gather_payloads.bytes") == (
        dense.nbytes)


def test_parallel_walk_counts_its_blocks():
    x = rows(8)
    buf, sc = st.SprintzCodec("delta", 1, device="cpu").compress_seekable(
        x, every_groups=4)
    before = trace.counters()
    checkpoint.decompress_parallel(buf, sc, device="cpu")
    after = trace.counters()
    ngroups, _, ndims = read_metadata_rle(buf)
    blocks = decoder.walk_headers(buf, ngroups, ndims, 1).total_rows // 8
    key = "decoder.walk_headers_parallel."
    assert delta(before, after, key + "data_blocks") + delta(
        before, after, key + "run_blocks") == blocks
    assert delta(before, after, "decoder.walk_headers.data_blocks") == 0


TRANSFERS = ["decoder.upload_payload", "decoder.upload_batch",
             "decoder.download_values", "encoder.upload_rows",
             "encoder.download_outputs"]


def test_transfer_counters_read_zero_on_cpu():
    before = trace.counters()
    for codec in ("delta", "xff"):
        c = st.SprintzCodec(codec, 1, device="cpu")
        c.decompress_batch(c.compress_batch([rows(8), rows(8, 1)]))
        c.decompress(c.compress(rows(2)))
    after = trace.counters()
    for fn in TRANSFERS:
        for kind in ("pageable_bytes", "pinned_bytes"):
            assert after[f"{fn}.{kind}"] == before[f"{fn}.{kind}"]


def test_count_transfer_splits_pinned_and_pageable():
    def copy():
        pass

    dev = torch.device("cuda")  # only its type is read
    trace.count_transfer(copy, dev, np.zeros(10, np.uint8),
                         torch.zeros(3, dtype=torch.int64))
    assert (copy.pageable_bytes, copy.pinned_bytes) == (34, 0)
    trace.count_transfer(copy, torch.device("cpu"), np.zeros(10, np.uint8))
    assert copy.pageable_bytes == 34


def test_threads_started_by_a_gather():
    """A gather of n row-major blocks of 1 byte a row takes
    ``parallel_for``'s threads: one for every 2 MiB of output, up to the
    host's cores and 64, none where one would do."""
    grain = (2 << 20) // 8
    n = 3 * grain
    want = min(n // grain, os.cpu_count(), 64)
    want = 0 if want <= 1 else want
    buf = np.arange(8, dtype=np.uint8)
    native_host.gather_blocks(buf, np.zeros(1, np.int64),
                              np.ones(1, np.int32), 1)  # loads the library
    before = trace.counters()
    out = native_host.gather_blocks(buf, np.zeros(n, np.int64),
                                    np.ones(n, np.int32), 1)
    after = trace.counters()
    assert np.array_equal(out[:2, :, 0], np.tile(buf, (2, 1)))
    assert delta(before, after, "native_host.threads_started") == want
    assert delta(before, after, "native_host.gather_blocks.threads") == want


def test_counter_found_under_a_wrapper(monkeypatch):
    """A caller's wrapper around a stage (the benchmark's, a mock's) does
    not take the stage's counters away from it."""
    original = decoder.walk_headers

    @functools.wraps(original)
    def wrapped(*args, **kwargs):
        return original(*args, **kwargs)

    monkeypatch.setattr(decoder, "walk_headers", wrapped)
    x = rows(8)
    buf = st.compress(x, device="cpu")
    before = trace.counters()
    st.decompress(buf, device="cpu")
    after = trace.counters()
    assert delta(before, after, "decoder.walk_headers.data_blocks") > 0
    assert "data_blocks" not in vars(wrapped) or (
        wrapped.data_blocks == before["decoder.walk_headers.data_blocks"])


def test_counters_names():
    got = trace.counters()
    for key in ("ops.decode_kernels.unpack_zz.launches",
                "native_host.walk_headers.calls",
                "native_host.threads_started",
                "decoder.upload_payload.pageable_bytes",
                "encoder.download_outputs.pinned_bytes",
                "api.SprintzCodec.decompress.calls",
                "planner.build_plan.calls"):
        assert isinstance(got[key], int), key
    assert all(not k.startswith("sprintz_tpu_torch.") for k in got)
    # each counter once, under its function's own name, not a loop's alias
    assert not [k for k in got if "._fn." in k]


def test_span_as_context_and_decorator_without_profiler():
    @trace.annotate("test.fn")
    def fn(a):
        return a + 1

    with trace.annotate("test.outside"):
        assert fn(1) == 2
    assert fn.__wrapped__.calls == 1 and fn.__name__ == "fn"

    def both():
        with trace.annotate("test.outside"):
            return fn(2)

    out, got = spans(both, ("test.",))
    assert out == 3 and [n for n, _, _ in got] == ["test.outside", "test.fn"]
    nested(got)
    assert fn.__wrapped__.calls == 2
