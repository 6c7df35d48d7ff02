"""The port's multi-process path (``sprintz_tpu_torch.parallel.multihost``)
over ``torch.distributed``: two gloo processes on the CPU
(``parallel/mp_check.py``, the counterpart of ``tests/mp_worker.py``), each
holding only its ``host_local_elems`` slice, compress with ``mp_compress``
and decode with ``mp_decompress``; their bytes equal the JAX package's
single-device ``encoder.compress`` (delta and xff, u8 and u16, RLE runs
across the process boundary) and, at one case, the JAX package's
``dp_decompress`` of them gives the input the workers decoded. Also the
in-process pieces: ``host_local_elems``'s partition at 1 to 4 processes,
the process group's variables, and the single-process degradation."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from sprintz_tpu import encoder as jencoder
from sprintz_tpu.parallel import multihost as jmh
from sprintz_tpu.parallel import shard as jshard
from sprintz_tpu_torch import encoder, native_host
from sprintz_tpu_torch.parallel import mp_check
from sprintz_tpu_torch.parallel import multihost as mh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both workers' output directory, after they ran and exited 0."""
    native_host.build()  # once here, so the two workers do not both build
    out = tmp_path_factory.mktemp("mp")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank),
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "sprintz_tpu_torch.parallel.mp_check",
             "--backend", "gloo", "--device", "cpu", "--out", str(out)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"rank {rank} failed:\n{logs[rank]}"
        line = (out / f"rank{rank}.out").read_text()
        assert line.startswith("OK "), line
    return out


@pytest.mark.parametrize("case", range(len(mp_check.SMALL)))
def test_two_process_gloo_bytes_equal_jax(two_ranks, case):
    codec, _, ndims, flat = mp_check.cases()[case]
    want = jencoder.compress(flat, ndims, codec=codec)
    for rank in range(2):
        assert (two_ranks / f"rank{rank}_case{case}.bin").read_bytes() == want


def test_two_process_stream_decodes_in_jax(two_ranks):
    """The JAX package's sharded decode of the workers' u16 delta stream
    gives the input, as the workers' mp_decompress did."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual JAX devices of tests/conftest.py")
    codec, dt, _, flat = mp_check.cases()[2]
    buf = (two_ranks / "rank0_case2.bin").read_bytes()
    np.testing.assert_array_equal(jshard.dp_decompress(
        jshard.make_mesh(8), buf, codec=codec, elem_sz=np.dtype(dt).itemsize),
        flat)


@pytest.mark.parametrize("ndims,n", [(7, 7 * 8 * 53 + 11), (6, 6 * 8 * 16),
                                     (3, 50), (5, 5 * 8 * 3 + 1)])
def test_host_local_elems_partition(ndims, n):
    """At 1 to 4 processes the slices are contiguous, in rank order, start
    on whole blocks and cover every element once; at one process it is the
    JAX package's."""
    sl = mh.host_local_elems(n, ndims)
    jsl = jmh.host_local_elems(n, ndims, n_dev=1)
    assert (sl.start, sl.stop) == (0, n) == (jsl.start, jsl.stop)
    for world in (2, 3, 4):
        parts = [mh.host_local_elems(n, ndims, rank=r, world=world)
                 for r in range(world)]
        assert parts[0].start == 0 and parts[-1].stop == n
        for a, b in zip(parts, parts[1:]):
            assert a.stop == b.start
        assert all(p.start % (8 * ndims) == 0 or p.start == n for p in parts)
        rows = [mh.host_local_rows(n // ndims, rank=r, world=world)
                for r in range(world)]
        assert rows[0].start == 0
        assert all(a.stop == b.start for a, b in zip(rows, rows[1:]))


def test_single_process_degrades_to_one_shard():
    assert mh.maybe_init_distributed("gloo") is False or \
        torch.distributed.is_initialized()
    with pytest.raises(ValueError):
        mh.maybe_init_distributed("mpi")
    mesh = mh.global_mesh("cpu")
    assert (mesh.rank, mesh.size) == (0, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mh.global_mesh()
    rng = np.random.default_rng(4)
    for codec, dt, ndims in (("delta", np.uint8, 9), ("xff", np.uint16, 5)):
        n = ndims * 8 * 41 + 3
        flat = rng.integers(0, 60, size=n).astype(dt)
        flat[n // 4: n // 4 + 500] = 9
        got = mh.mp_compress(flat, n, ndims, codec, mesh)
        assert got == encoder.compress(flat, ndims, codec, device="cpu")
        np.testing.assert_array_equal(
            mh.mp_decompress(got, codec, np.dtype(dt).itemsize, mesh), flat)
    with pytest.raises(ValueError, match="must pass elements"):
        mh.mp_compress(flat[:-1], n, ndims, "delta", mesh)
