"""The multi-shard dry run: one of each sharded path, end to end.

Counterpart of the JAX package's ``__graft_entry__.py:dryrun_multichip``:
on a mesh of ``n_shards`` it runs the sharded encode -> decode step for
delta and FIRE, ``dp_decompress`` from stream bytes (FIRE without and with
a sidecar, the lowdim layout), ``dp_compress`` against ``compress``, and
+Huf (the encoder kernel and K6) on the sharded stream, then its decode;
each must give back its input exactly, or it raises ``AssertionError``.
"""

from __future__ import annotations

import numpy as np

from .. import checkpoint, encoder
from ..entropy import huffman as hf
from . import shard


def dryrun_multichip(n_shards: int, devices=None) -> None:
    """Run the dry run on ``make_mesh(n_shards, devices)``: by default one
    shard on each CUDA device (raises without CUDA or with fewer cards than
    shards); ``devices=["cpu"] * 8`` is the tests', ``["cuda:0"] * 4``
    four shards on one card."""
    mesh = shard.make_mesh(n_shards, devices)
    dev = mesh.devices[0]
    rng = np.random.default_rng(0)
    ndims = 8
    rows_per_shard = 4 * 8  # 4 blocks a shard
    rows = (np.cumsum(rng.integers(-3, 4, (n_shards * rows_per_shard, ndims)),
                      axis=0) % 256).astype(np.int32)
    want = rows.astype(np.uint8)
    decoded, nbytes = shard.training_step(mesh, rows, elem_sz=1, codec="delta")
    assert np.array_equal(shard.gather_rows(mesh, decoded), want), (
        "sharded roundtrip failed")
    assert nbytes > 0
    # FIRE through the chain of carries across the shards
    decoded_x, _ = shard.training_step(mesh, rows, elem_sz=1, codec="xff")
    assert np.array_equal(shard.gather_rows(mesh, decoded_x), want), (
        "sharded xff failed")
    # the sharded decode from stream bytes
    flat = want.reshape(-1)
    buf = encoder.compress(flat, ndims, codec="xff", device=dev)
    out = shard.dp_decompress(mesh, buf, codec="xff", elem_sz=1)
    assert np.array_equal(out, flat), "dp_decompress mismatch"
    # with a sidecar: the parallel walk, and each shard's checkpoints
    # decoded from their states (no chain)
    buf2, sc = checkpoint.compress_with_sidecar(flat, ndims, codec="xff",
                                                every_groups=2, device=dev)
    out2 = shard.dp_decompress(mesh, buf2, codec="xff", elem_sz=1, sidecar=sc)
    assert np.array_equal(out2, flat), "dp_decompress sidecar mismatch"
    # the lowdim (column-major) layout
    flat4 = rows[:, :4].astype(np.uint8).reshape(-1)
    buf3 = encoder.compress(flat4, 4, codec="delta", device=dev)
    out3 = shard.dp_decompress(mesh, buf3, codec="delta", elem_sz=1)
    assert np.array_equal(out3, flat4), "dp_decompress lowdim mismatch"
    # the sharded encode writes the single-device stream
    multi = shard.dp_compress(mesh, flat, ndims, codec="delta")
    single = encoder.compress(flat, ndims, codec="delta", device=dev)
    assert multi == single, "dp_compress not byte-identical"
    # +Huf on the sharded stream, decoded back through the sharded decode
    payload = np.frombuffer(multi, np.uint8)
    comp = hf.huff_compress(payload, chunk_symbols=128, allow_stored=False,
                            device=dev)
    plain = hf.huff_decompress(comp, device=dev)
    assert np.array_equal(plain, payload), "+Huf roundtrip mismatch"
    out4 = shard.dp_decompress(mesh, plain.tobytes(), codec="delta", elem_sz=1)
    assert np.array_equal(out4, flat), "+Huf -> dp_decompress mismatch"
