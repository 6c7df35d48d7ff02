"""The port's CLI (``python -m sprintz_tpu_torch ... --device cpu``)
against the JAX package's (``sprintz_tpu.__main__.main``), in-process:
byte-identical SPZT2 containers (raw, +Huf, each sidecar mode) and bare
streams, each CLI reading the other's files and SPZT1 containers, the same
``info`` and ``query`` output and exit codes, rc 2 on a misaligned
``--ndims``; and the port's ``validate_stream`` against the JAX package's
on valid, truncated and garbage streams (``tests/test_validate.py``'s
cases)."""

import ast
import subprocess
import sys

import numpy as np
import pytest

from sprintz_tpu import __main__ as jcli
from sprintz_tpu import encoder as jenc
from sprintz_tpu.validate import validate_stream as jvalidate
from sprintz_tpu_torch import __main__ as tcli
from sprintz_tpu_torch import encoder as tenc
from sprintz_tpu_torch.validate import validate_stream as tvalidate

from conftest import make_stream

CPU = ["--device", "cpu"]


def raw_file(tmp_path, rng, es=1, smooth=False):
    """A raw file of 3000 x 8 walk rows (steps in [-5, 5], or [-1, 1] where
    Huffman coding pays)."""
    step = 1 if smooth else 5
    dt = np.uint8 if es == 1 else np.uint16
    data = (np.cumsum(rng.integers(-step, step + 1, (3000, 8)), axis=0)
            % (1 << (8 * es))).astype(dt)
    p = tmp_path / "raw.bin"
    data.tofile(p)
    return p, data


def run_both(capsys, args_j, args_t):
    """(rc, stdout) of the JAX CLI and of the port's."""
    rc_j = jcli.main(args_j)
    out_j = capsys.readouterr().out
    rc_t = tcli.main(args_t + CPU)
    out_t = capsys.readouterr().out
    return (rc_j, out_j), (rc_t, out_t)


@pytest.mark.parametrize("codec,entropy,sidecar", [
    ("delta", "none", "auto"), ("delta", "huffman", "auto"),
    ("delta", "none", "always"), ("xff", "none", "auto"),
    ("xff", "huffman", "auto"), ("xff", "none", "never"),
    ("xff", "huffman", "always")])
def test_containers_equal_jax(tmp_path, rng, capsys, codec, entropy, sidecar):
    raw, data = raw_file(tmp_path, rng, smooth=entropy == "huffman")
    j_spz, t_spz = tmp_path / "j.spz", tmp_path / "t.spz"
    flags = ["--ndims", "8", "--codec", codec, "--entropy", entropy,
             "--sidecar", sidecar]
    (rc_j, _), (rc_t, _) = run_both(
        capsys, ["compress", str(raw), str(j_spz)] + flags,
        ["compress", str(raw), str(t_spz)] + flags)
    assert rc_j == rc_t == 0
    assert t_spz.read_bytes() == j_spz.read_bytes()
    assert t_spz.read_bytes()[:5] == tcli.MAGIC
    # each CLI decodes the other's file (no flags: the container has them)
    j_out, t_out = tmp_path / "j.bin", tmp_path / "t.bin"
    assert jcli.main(["decompress", str(t_spz), str(j_out)]) == 0
    assert tcli.main(["decompress", str(j_spz), str(t_out)] + CPU) == 0
    for out in (j_out, t_out):
        np.testing.assert_array_equal(np.fromfile(out, np.uint8),
                                      data.reshape(-1))
    (rc_j, info_j), (rc_t, info_t) = run_both(
        capsys, ["info", str(j_spz)], ["info", str(t_spz)])
    assert (rc_t, info_t) == (rc_j, info_j)
    for op in ("sum", "max", "min"):
        (rc_j, q_j), (rc_t, q_t) = run_both(
            capsys, ["query", str(j_spz), "--op", op],
            ["query", str(t_spz), "--op", op])
        assert (rc_t, q_t) == (rc_j, q_j)


@pytest.mark.parametrize("codec,entropy", [("delta", "none"),
                                           ("xff", "none"),
                                           ("delta", "huffman")])
def test_raw_streams_equal_jax(tmp_path, rng, capsys, codec, entropy):
    raw, data = raw_file(tmp_path, rng, es=2)
    j_spz, t_spz = tmp_path / "j.raw", tmp_path / "t.raw"
    flags = ["--ndims", "8", "--dtype", "u16", "--codec", codec,
             "--entropy", entropy, "--raw"]
    assert jcli.main(["compress", str(raw), str(j_spz)] + flags) == 0
    assert tcli.main(["compress", str(raw), str(t_spz)] + flags + CPU) == 0
    assert t_spz.read_bytes() == j_spz.read_bytes()
    if entropy == "none":
        assert t_spz.read_bytes() == tenc.compress(
            data.reshape(-1), 8, codec, device="cpu")
    read = ["--dtype", "u16", "--codec", codec, "--entropy", entropy, "--raw"]
    out = tmp_path / "rt.bin"
    assert tcli.main(["decompress", str(j_spz), str(out)] + read + CPU) == 0
    np.testing.assert_array_equal(np.fromfile(out, np.uint16),
                                  data.reshape(-1))
    (rc_j, info_j), (rc_t, info_t) = run_both(
        capsys, ["info", str(j_spz)] + read, ["info", str(t_spz)] + read)
    assert (rc_t, info_t) == (rc_j, info_j) and rc_t == 0
    (rc_j, q_j), (rc_t, q_t) = run_both(
        capsys, ["query", str(j_spz), "--op", "max"] + read,
        ["query", str(t_spz), "--op", "max"] + read)
    assert (rc_t, q_t) == (rc_j, q_j)
    assert ast.literal_eval(q_t.strip()) == data.max(axis=0).tolist()


def test_reads_spzt1_and_bare_streams(tmp_path, rng, capsys):
    raw, data = raw_file(tmp_path, rng)
    stream = jenc.compress(data.reshape(-1), 8, codec="xff")
    v1 = tmp_path / "v1.spz"
    v1.write_bytes(tcli.MAGIC_V1 + bytes([1]) + stream)  # xff, u8, none
    out = tmp_path / "rt.bin"
    assert tcli.main(["decompress", str(v1), str(out)] + CPU) == 0
    np.testing.assert_array_equal(np.fromfile(out, np.uint8),
                                  data.reshape(-1))
    (rc_j, info_j), (rc_t, info_t) = run_both(
        capsys, ["info", str(v1)], ["info", str(v1)])
    assert (rc_t, info_t) == (rc_j, info_j)
    # a bare stream without --raw: the note on stderr, then the flags
    bare = tmp_path / "bare.spz"
    bare.write_bytes(stream)
    assert tcli.main(["decompress", str(bare), str(out), "--codec",
                      "xff"] + CPU) == 0
    assert "no SPZT container header" in capsys.readouterr().err
    np.testing.assert_array_equal(np.fromfile(out, np.uint8),
                                  data.reshape(-1))


def test_misaligned_ndims_and_invalid_streams(tmp_path, rng, capsys):
    raw, data = raw_file(tmp_path, rng)
    (rc_j, _), (rc_t, _) = run_both(
        capsys, ["compress", str(raw), str(tmp_path / "x"), "--ndims", "7"],
        ["compress", str(raw), str(tmp_path / "y"), "--ndims", "7"])
    assert rc_j == rc_t == 2
    spz = tmp_path / "cut.spz"
    stream = jenc.compress(data.reshape(-1), 8)
    spz.write_bytes(tcli.MAGIC + tcli._pack_flags("delta", 1, "none")
                    + stream[: len(stream) // 2])
    (rc_j, info_j), (rc_t, info_t) = run_both(
        capsys, ["info", str(spz)], ["info", str(spz)])
    assert (rc_t, info_t) == (rc_j, info_j) and rc_t == 1
    with pytest.raises(AssertionError):
        tcli._pack_flags("delta", 4, "none")


def test_cli_defaults_to_the_card(tmp_path, rng):
    """Without ``--device`` the CLI runs on CUDA, and fails without it."""
    raw, _ = raw_file(tmp_path, rng)
    proc = subprocess.run(
        [sys.executable, "-m", "sprintz_tpu_torch", "compress", str(raw),
         str(tmp_path / "o.spz"), "--ndims", "8"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr


def _report(rep):
    return (rep.ok, rep.ndims, rep.ngroups, rep.total_rows, rep.data_blocks,
            rep.run_blocks, rep.stream_bytes, rep.errors)


@pytest.mark.parametrize("codec", ["delta", "xff"])
@pytest.mark.parametrize("ndims", [1, 9])
@pytest.mark.parametrize("es", [1, 2])
def test_validate_equals_jax(rng, codec, ndims, es):
    x = make_stream(rng, 600 * ndims, es, "sparse")
    buf = tenc.compress(x, ndims, codec=codec, device="cpu")
    assert tvalidate(buf, es).ok
    assert _report(tvalidate(buf, es)) == _report(jvalidate(buf, es))
    for cut in (4, 9, len(buf) // 2, len(buf) - 1):
        rep = tvalidate(buf[:cut], es)
        assert not rep.ok and rep.errors
        assert _report(rep) == _report(jvalidate(buf[:cut], es))


def test_validate_garbage_equals_jax():
    for buf in (b"\xff" * 64, b"\x00" * 64, bytes(range(200)), b"\x01\x00"):
        assert _report(tvalidate(buf)) == _report(jvalidate(buf))
