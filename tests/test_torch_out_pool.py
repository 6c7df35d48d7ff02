"""The decode's output pool (``decoder._OutPool``, ``_Lease``, ``_room``) on
the CPU: ``decompress`` still gives back its input, in every codec, width
and layout, with and without runs and a verbatim tail, and across segments
that make ``_room`` grow; a result's block goes back to the pool only when
the last array over it dies, so that live results and their views never
share memory and keep their values through later calls; the pool holds
at most ``OUT_FREE_BLOCKS`` free blocks, also when a block comes back
while its lock is held; the counters ``fresh_bytes`` and
``recycled_bytes``; a short download leaving zeros, not an earlier
result's values; and the host library's ``copy``, through which the
join writes a large copy, on fewer threads into a fresh block than into
a recycled one."""

import gc
import sys
import threading
import types

import numpy as np
import pytest

from sprintz_tpu_torch import decoder, encoder, native_host
from sprintz_tpu_torch.stream_format import read_metadata_rle
from sprintz_tpu_torch.utils import trace

# (elem_sz, ndims): row-major and lowdim at each width
SHAPES = [(1, 80), (1, 3), (2, 5), (2, 2)]


@pytest.fixture
def pool(monkeypatch):
    """A pool of this test's own: blocks that other tests' results give
    back go to the module's."""
    mine = decoder._OutPool(decoder.OUT_FREE_BLOCKS)
    monkeypatch.setattr(decoder, "_OUT", mine)
    return mine


def stream(seed: int, rows: int, ndims: int, elem_sz: int, runs: bool,
           tail: int) -> np.ndarray:
    """A flat random walk of ``rows`` rows and ``tail`` elements more; with
    ``runs`` every third stretch of 40 rows constant (run blocks)."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(-6, 7, (rows, ndims))
    if runs:
        steps[(np.arange(rows) // 40 % 3 == 0)] = 0
    walk = np.cumsum(steps, axis=0) % (1 << (8 * elem_sz))
    x = walk.astype(np.uint8 if elem_sz == 1 else np.uint16).reshape(-1)
    return np.concatenate([x, x[:tail]])


def decode(buf: bytes, codec: str, elem_sz: int) -> np.ndarray:
    return decoder.decompress(buf, codec=codec, elem_sz=elem_sz, device="cpu")


def lease_of(a: np.ndarray):
    base = a.base
    while isinstance(base, np.ndarray):
        base = base.base
    return base


def delta(before: dict, after: dict, key: str) -> int:
    return after[key] - before[key]


@pytest.mark.parametrize("tail", [0, 3])
@pytest.mark.parametrize("runs", [False, True])
@pytest.mark.parametrize("elem_sz,ndims", SHAPES)
@pytest.mark.parametrize("codec", ["delta", "xff"])
def test_values_fresh_and_recycled(pool, codec, elem_sz, ndims, runs, tail):
    """The input back from a fresh block and from a recycled one; the
    result is a flat, writable, C-contiguous array of the input's dtype
    that does not own its data."""
    x = stream(ndims + 7 * elem_sz, 333, ndims, elem_sz, runs, tail)
    buf = encoder.compress(x, ndims, codec=codec, device="cpu")
    before = trace.counters()
    first = decode(buf, codec, elem_sz)
    np.testing.assert_array_equal(first, x)
    del first
    again = decode(buf, codec, elem_sz)
    after = trace.counters()
    np.testing.assert_array_equal(again, x)
    assert again.dtype == x.dtype and again.shape == x.shape
    assert again.flags.c_contiguous and again.flags.writeable
    assert not again.flags.owndata
    assert lease_of(again).recycled
    assert delta(before, after, "decoder._room.recycled_bytes") >= x.nbytes


@pytest.mark.parametrize("elem_sz,ndims", SHAPES)
def test_segmented_xff_grows_and_slices(pool, monkeypatch, elem_sz, ndims):
    """An xff stream in several segments, long runs in the middle ones:
    ``_room`` grows its array where the runs come, past the rows that the
    last segments bring, so the result is a view shorter than its block;
    the recycled block decodes it again."""
    monkeypatch.setattr(decoder, "PIPE_BYTES", 1)
    monkeypatch.setattr(decoder, "PIPE_GROUPS", 1)
    monkeypatch.setattr(decoder, "PIPE_SEGMENTS", 6)
    head = stream(5, 240, ndims, elem_sz, False, 0)
    flat = np.repeat(head[-ndims:][None], 1600, axis=0).reshape(-1)
    x = np.concatenate([head, flat, stream(6, 240, ndims, elem_sz, False, 1)])
    buf = encoder.compress(x, ndims, codec="xff", device="cpu")
    ngroups, _, _ = read_metadata_rle(buf)
    assert len(decoder.segment_plan("xff", ngroups, len(buf))) > 1
    takes = []
    take = pool.take
    monkeypatch.setattr(pool, "take", lambda *a: takes.append(a) or take(*a))
    got = decode(buf, "xff", elem_sz)
    np.testing.assert_array_equal(got, x)
    assert len(takes) >= 2  # grown
    assert lease_of(got).block.nbytes > got.nbytes  # cut by a view
    del got
    again = decode(buf, "xff", elem_sz)
    np.testing.assert_array_equal(again, x)
    assert lease_of(again).recycled


def test_results_stay_intact(pool):
    """Two results keep their values through four later calls that
    recycle blocks of their size."""
    xs = [stream(s, 500, 80, 1, False, 5) for s in range(6)]
    bufs = [encoder.compress(x, 80, device="cpu") for x in xs]
    a, b = decode(bufs[0], "delta", 1), decode(bufs[1], "delta", 1)
    before = trace.counters()
    for k in range(2, 6):
        np.testing.assert_array_equal(decode(bufs[k], "delta", 1), xs[k])
    after = trace.counters()
    assert delta(before, after, "decoder._room.recycled_bytes") > 0
    np.testing.assert_array_equal(a, xs[0])
    np.testing.assert_array_equal(b, xs[1])


def test_view_keeps_its_block(pool):
    """A view that outlives its result keeps the block out of the pool
    and its values through later calls; the block comes back when the
    view dies."""
    xs = [stream(s, 400, 80, 1, True, 0) for s in range(3)]
    bufs = [encoder.compress(x, 80, device="cpu") for x in xs]
    got = decode(bufs[0], "delta", 1)
    view = got.reshape(-1, 80)[3:-3, 1:]
    block = lease_of(got).block
    del got
    gc.collect()
    assert not any(b is block for b in pool.free)
    for k in range(4):
        np.testing.assert_array_equal(decode(bufs[1 + k % 2], "delta", 1),
                                      xs[1 + k % 2])
    np.testing.assert_array_equal(view, xs[0].reshape(-1, 80)[3:-3, 1:])
    del view
    assert any(b is block for b in pool.free)


def test_live_results_never_share_memory(pool):
    xs = [stream(s, 300, 80, 1, False, 0) for s in range(4)]
    bufs = [encoder.compress(x, 80, device="cpu") for x in xs]
    live = []
    for k in range(12):
        live.append(decode(bufs[k % 4], "delta", 1))
        if k % 3 == 2:
            live.pop(0)  # a block back to the pool, for the next call
    for i, a in enumerate(live):
        for b in live[i + 1:]:
            assert not np.shares_memory(a, b)
    for k, a in zip(range(12 - len(live), 12), live):
        np.testing.assert_array_equal(a, xs[k % 4])


def test_pool_holds_at_most_two(pool):
    assert decoder.OUT_FREE_BLOCKS == 2
    xs = [stream(s, 64 * (s + 1), 80, 1, False, 0) for s in range(5)]
    held = [decode(encoder.compress(x, 80, device="cpu"), "delta", 1)
            for x in xs]
    assert pool.free == []
    blocks = [lease_of(a).block for a in held]
    for k in range(5):
        held.pop(0)
        assert len(pool.free) == min(k + 1, 2)
    # the newest two given back stay
    assert [id(b) for b in pool.free] == [id(b) for b in blocks[3:]]


def test_block_given_back_while_the_lock_is_held(pool):
    """A result dropped while the pool's lock is held (the garbage
    collector inside ``take``, or another thread) does not wait for the
    lock; the holder files its block on the way out."""
    x = stream(1, 200, 80, 1, False, 0)
    buf = encoder.compress(x, 80, device="cpu")
    got = decode(buf, "delta", 1)
    done = threading.Event()

    def drop():
        nonlocal got
        got = None
        done.set()

    with pool._lock:
        worker = threading.Thread(target=drop)
        worker.start()
        worker.join(timeout=30)
        assert done.is_set() and not worker.is_alive()
        assert pool.free == [] and len(pool._back) == 1
    pool._settle()
    assert len(pool.free) == 1 and not pool._back
    np.testing.assert_array_equal(decode(buf, "delta", 1), x)


def test_threads_share_the_pool(pool):
    """16 threads decode and drop results at once, switching every
    microsecond: every result is right, the live ones never share memory,
    and the pool ends with at most two free blocks, none under a live
    result."""
    xs = [stream(s, 300, 80, 1, s == 1, 2) for s in range(2)]
    bufs = [encoder.compress(x, 80, device="cpu") for x in xs]
    errors, live, lock = [], [], threading.Lock()

    def work(k):
        try:
            held = []
            for i in range(16):
                x = xs[(k + i) % 2]
                got = decode(bufs[(k + i) % 2], "delta", 1)
                if not np.array_equal(got, x):
                    errors.append(f"thread {k}, call {i}: wrong values")
                held = held[-1:] + [(got, x)]
            with lock:
                live.extend(held)
        except Exception as e:  # reported below, with the thread's number
            errors.append(f"thread {k}: {e!r}")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert not errors, errors[:3]
    assert len(live) == 32
    for i, (a, x) in enumerate(live):
        np.testing.assert_array_equal(a, x)
        assert not any(np.shares_memory(a, b) for b, _ in live[i + 1:])
        assert not any(np.shares_memory(a, b) for b in pool.free)
    assert len(pool.free) <= 2


def test_short_download_leaves_no_earlier_values(pool, monkeypatch):
    """Values that come up short of their segment (a device pass gone
    wrong) leave zeros in a recycled block, as fresh pages would, never
    the earlier result's values there."""
    x = stream(8, 400, 80, 1, False, 0) | 1  # no zero among them
    buf = encoder.compress(x, 80, device="cpu")
    np.testing.assert_array_equal(decode(buf, "delta", 1), x)  # dropped
    download = decoder.download_values
    monkeypatch.setattr(decoder, "download_values",
                        lambda vals: download(vals)[:x.size // 2])
    got = decode(buf, "delta", 1)
    assert lease_of(got).recycled
    np.testing.assert_array_equal(got[:x.size // 2], x[:x.size // 2])
    assert not got[x.size // 2:].any()


def test_take_fits(pool):
    """``take``: the smallest free block of ``need`` to twice ``want``
    bytes, else none."""
    pool.give(np.empty(100, np.uint8))
    pool.give(np.empty(300, np.uint8))
    assert pool.take(250, 260).nbytes == 300
    assert pool.take(101, 120) is None  # 100 is too small
    assert pool.take(40, 45) is None  # 100 is over twice 45
    assert pool.take(40, 50).nbytes == 100
    assert pool.free == []


def test_counters_count_blocks(pool):
    """``fresh_bytes``: the bytes of blocks allocated anew; ``recycled_
    bytes``: those of blocks served from the pool."""
    x = stream(2, 640, 80, 1, False, 0)
    buf = encoder.compress(x, 80, device="cpu")
    key = "decoder._room."
    c0 = trace.counters()
    a = decode(buf, "delta", 1)
    c1 = trace.counters()
    assert delta(c0, c1, key + "fresh_bytes") == x.nbytes
    assert delta(c0, c1, key + "recycled_bytes") == 0
    b = decode(buf, "delta", 1)  # a is alive: fresh again
    c2 = trace.counters()
    assert delta(c1, c2, key + "fresh_bytes") == x.nbytes
    del a
    c = decode(buf, "delta", 1)
    c3 = trace.counters()
    assert delta(c2, c3, key + "fresh_bytes") == 0
    assert delta(c2, c3, key + "recycled_bytes") == x.nbytes
    np.testing.assert_array_equal(b, x)
    np.testing.assert_array_equal(c, x)


@pytest.mark.parametrize("threshold", [1, None])
def test_join_threads_by_block(pool, monkeypatch, threshold):
    """The join copies through ``native_host.copy`` from
    ``THREAD_COPY_BYTES`` on (lowered here, so that a small stream reaches
    it): on up to ``FRESH_COPY_THREADS`` threads into a fresh block, on up
    to the host's cores into a recycled one; below it, through numpy."""
    if threshold is not None:
        monkeypatch.setattr(decoder, "THREAD_COPY_BYTES", threshold)
    x = stream(3, 800, 80, 1, False, 0)
    assert x.nbytes < decoder.THREAD_COPY_BYTES or threshold
    buf = encoder.compress(x, 80, device="cpu")
    seen = []

    def spy(dst, src, threads=64):
        seen.append(threads)
        native_host.copy(dst, src, threads)
    monkeypatch.setattr(decoder, "native_host", types.SimpleNamespace(
        **{**vars(native_host), "copy": spy}))
    got = decode(buf, "delta", 1)
    del got
    got = decode(buf, "delta", 1)
    np.testing.assert_array_equal(got, x)
    if threshold is None:
        assert seen == []
    else:
        assert seen == [decoder.FRESH_COPY_THREADS, 64]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("n", [0, 1, 7, 4095, 4097, (4 << 20) + 13])
def test_native_copy_matches_numpy(n, dtype):
    """Odd lengths, none, and one of several threads' grains (2 MiB)."""
    src = np.random.default_rng(n).integers(0, 1 << 16, n).astype(dtype)
    for threads in (1, 64):
        dst = np.full(n + 2, 7, dtype)
        native_host.copy(dst[1:n + 1], src, threads)
        np.testing.assert_array_equal(dst[1:n + 1], src)
        assert dst[0] == dst[-1] == 7


def test_native_copy_refuses_mismatches():
    with pytest.raises(ValueError):
        native_host.copy(np.empty(4, np.uint8), np.empty(5, np.uint8))
    with pytest.raises(ValueError):
        native_host.copy(np.empty(8, np.uint8)[::2], np.empty(4, np.uint8))
    ro = np.empty(4, np.uint8)
    ro.flags.writeable = False
    with pytest.raises(ValueError):
        native_host.copy(ro, np.empty(4, np.uint8))


def test_results_writable_apart(pool):
    """Writing into one result changes no other, nor a later call's."""
    x = stream(4, 300, 80, 1, True, 3)
    buf = encoder.compress(x, 80, device="cpu")
    a, b = decode(buf, "delta", 1), decode(buf, "delta", 1)
    a[:] = 9
    np.testing.assert_array_equal(b, x)
    del a
    np.testing.assert_array_equal(decode(buf, "delta", 1), x)
