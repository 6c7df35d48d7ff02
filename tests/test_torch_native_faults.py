"""The port's host library on corrupt streams and without a compiler:
every truncation of a stream raises ``CorruptStreamError`` in the port as
in the JAX package, a metadata group count of billions raises it too (not
``MemoryError``), and a missing or failing g++ raises ``RuntimeError``,
keeps no library and lets nothing fall back to the Python versions."""

import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from sprintz_tpu import decoder as jdec
from sprintz_tpu.errors import CorruptStreamError as JaxCorruptStreamError
from sprintz_tpu_torch import decoder, encoder, native_host
from sprintz_tpu_torch.constants import LOWDIM_MAX_NDIMS
from sprintz_tpu_torch.entropy import huffman as hf
from sprintz_tpu_torch.errors import CorruptStreamError
from sprintz_tpu_torch.ops import _build
from sprintz_tpu_torch.stream_format import read_metadata_rle

REPO = pathlib.Path(__file__).resolve().parent.parent

# (elem_sz, ndims, rows, kind): row-major with and without BMI2's
# byte-aligned headers (D % 8 == 0), lowdim u8 and u16, runs, a tail
STREAMS = [(1, 5, 61, "walk"), (1, 64, 21, "walk"), (1, 4, 101, "runs"),
           (2, 2, 77, "walk"), (2, 7, 40, "runs"), (1, 16, 48, "runs")]


def small_stream(elem_sz: int, ndims: int, rows: int, kind: str):
    rng = np.random.default_rng(ndims * 100 + rows)
    steps = rng.integers(-6, 7, (rows, ndims))
    if kind == "runs":
        steps[(np.arange(rows) // 24) % 2 == 1] = 0
    x = np.cumsum(steps, axis=0) % (1 << (8 * elem_sz))
    x = x.astype(np.uint8 if elem_sz == 1 else np.uint16).reshape(-1)
    return x, encoder.compress(x, ndims, device="cpu")


def raises(fn, exc) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


@pytest.mark.parametrize("elem_sz,ndims,rows,kind", STREAMS)
def test_every_truncation_raises_like_jax(elem_sz, ndims, rows, kind):
    """Cut at every byte, the stream raises in the port's decompress and in
    the JAX package's; the native walk raises exactly where the port's and
    the JAX package's Python walks do, and agrees with them elsewhere (a
    cut in the tail leaves the walk whole)."""
    x, buf = small_stream(elem_sz, ndims, rows, kind)
    ngroups, _, _ = read_metadata_rle(buf)
    lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]
    assert ngroups > 0
    np.testing.assert_array_equal(
        decoder.decompress(buf, elem_sz=elem_sz, device="cpu"), x)
    walk_raised = 0
    for cut in range(len(buf)):
        part = buf[:cut]
        with pytest.raises(CorruptStreamError):
            decoder.decompress(part, elem_sz=elem_sz, device="cpu")
        with pytest.raises(JaxCorruptStreamError):
            jdec.decompress(part, elem_sz=elem_sz)
        if cut < 8:
            continue
        nat = raises(lambda: decoder.walk_headers(
            part, ngroups, ndims, elem_sz, lowdim), CorruptStreamError)
        py = raises(lambda: decoder._walk_headers_py(
            part, ngroups, ndims, elem_sz, lowdim), CorruptStreamError)
        jpy = raises(lambda: jdec._walk_headers_py(
            part, ngroups, ndims, elem_sz, lowdim=lowdim),
            JaxCorruptStreamError)
        assert nat == py == jpy, cut
        walk_raised += nat
        if not nat:
            got = decoder.walk_headers(part, ngroups, ndims, elem_sz, lowdim)
            want = decoder._walk_headers_py(part, ngroups, ndims, elem_sz,
                                            lowdim)
            np.testing.assert_array_equal(got.widths, want.widths)
            assert got.tail_offset == want.tail_offset
    assert walk_raised > 0


@pytest.mark.parametrize("ngroups", [0x7FFFFFFF, 0xFFFFFFFF])
@pytest.mark.parametrize("elem_sz,ndims", [(1, 64), (1, 4), (2, 2)])
def test_huge_group_count_raises_corrupt_stream(ngroups, elem_sz, ndims):
    """The metadata's group count set to billions on a stream of about
    143 KB: the walk sizes its outputs by the stream and raises
    ``CorruptStreamError``, as the JAX package's Python walk does (its
    native walk allocates 2 * ngroups rows first)."""
    rows = 143_000 // (ndims * elem_sz)
    x, buf = small_stream(elem_sz, ndims, rows, "walk")
    bad = int(ngroups).to_bytes(4, "little") + buf[4:]
    lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]
    with pytest.raises(CorruptStreamError):
        decoder.decompress(bad, elem_sz=elem_sz, device="cpu")
    with pytest.raises(CorruptStreamError):
        decoder.walk_headers(bad, ngroups, ndims, elem_sz, lowdim)
    with pytest.raises(JaxCorruptStreamError):
        jdec._walk_headers_py(bad, ngroups, ndims, elem_sz, lowdim=lowdim)


@pytest.fixture
def fresh_library():
    """A stream made with the library, then the library's loader emptied,
    and emptied again after the test, so that neither a cached library nor
    a failed build leaks."""
    stream = small_stream(1, 5, 61, "walk")
    native_host._library.cache_clear()
    yield stream
    native_host._library.cache_clear()


def assert_nothing_falls_back(tmp_path: pathlib.Path, x, buf):
    ngroups, _, _ = read_metadata_rle(buf)
    calls = [lambda: decoder.walk_headers(buf, ngroups, 5, 1),
             lambda: decoder.decompress(buf, device="cpu"),
             lambda: encoder.compress(x, 5, device="cpu"),
             lambda: hf.build_table(x)]
    for fn in calls:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            fn()
    assert not list(tmp_path.rglob("*.so")), "a library was kept"
    assert not list(tmp_path.rglob("*.tmp")), "a partial library was kept"


def test_missing_gxx_raises(tmp_path, monkeypatch, fresh_library):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_host.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_host.build()
    assert_nothing_falls_back(tmp_path, *fresh_library)


def test_failing_gxx_raises(tmp_path, monkeypatch, fresh_library):
    """A compiler that fails at once (``false``) and g++ on a source that
    does not compile: each raises with the compiler's output."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    fails = shutil.which("false")  # exits 1 whatever its arguments
    with monkeypatch.context() as m:
        m.setattr(native_host.shutil, "which", lambda _: fails)
        with pytest.raises(RuntimeError, match=r"g\+\+ failed \(rc 1\)"):
            native_host.build()
        assert_nothing_falls_back(tmp_path, *fresh_library)
    src = tmp_path / "sprintz_host.cpp"
    src.write_text('extern "C" int sprintz_walk_headers( { no C++ here\n')
    monkeypatch.setattr(native_host, "SRC", src)
    with pytest.raises(RuntimeError,
                       match=r"g\+\+ failed:\nsprintz_host\.cpp \(rc 1\): "
                             r"(?s:.*)error") as e:
        native_host.build()
    assert "no C++ here" in str(e.value)
    assert_nothing_falls_back(tmp_path, *fresh_library)


def test_concurrent_builds_share_one_library(tmp_path):
    """Three processes build into one empty directory at once, as test
    workers do: each gets the same library, and no partial file stays."""
    code = ("import pathlib, sys\n"
            "from sprintz_tpu_torch.ops import _build\n"
            "_build.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
            "from sprintz_tpu_torch import native_host\n"
            "print(native_host.build())\n"
            "print(native_host.histogram(b'abca')[97])\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {out.split()[0] for out, _ in outs}
    assert len(paths) == 1 and [out.split()[1] for out, _ in outs] == ["2"] * 3
    assert [p.name for p in tmp_path.iterdir()] == [pathlib.Path(
        paths.pop()).name]
