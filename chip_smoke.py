#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sprintz_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

1. build: compile ``sprintz_tpu_torch/csrc/*.cu`` with nvcc for sm_90a into
   ``build/sprintz_tpu_torch/``, one nvcc per source, all at once, and the
   host library ``csrc/sprintz_host.cpp`` with g++ (set-up time; the g++
   and its flags are printed);
2. kernels: every kernel against its plain PyTorch version on the card,
   bit-exact: K1 unpack_zz (biased deltas and tile offsets), K4
   unpack_rows, K5 (K4's narrow mode), K2 prefix_finish and K3 pack_rows
   at the main path's shapes and at a ragged shape; FIRE encode and
   decode (csrc/fire.cu, decode also from a carried state) over the
   whole main-path streams, u8 and u16 at D 64
   and D 129, then at the shapes that stress its ring of row tiles (one
   block, one block less and more than a tile, fewer tiles than the ring,
   more than the ring; D 1, 31, 33, 129) and from carried states whose
   counter wraps within the stream; K6 huff_decode and huff_encode on the
   8 MiB headline's sprintz stream at chunk_symbols 128 and on a small
   stream at 4096; K3 and huff_encode at the encode side's edge shapes
   (``sprintz_tpu_torch/probes/encode_cases.py``, the list the CPU tests
   hold the plain versions to: K3 at D 5-1024 over ragged tiles of
   all-zero, all-maximum and random widths; the encoder at chunk sizes 1,
   31, 128 and 4096 with a ragged last chunk, fewer symbols than a chunk,
   only 12-bit codes, one symbol value); K6 at the decode side's cases
   (``sprintz_tpu_torch/probes/decode_cases.py``: the same chunk sizes and
   kinds, zero padding that decodes to extra symbols, an overrun chunk in
   the middle and at the end), symbols and overrun counts, and at chunk
   size 20000, above a CTA's window of payload; K1, K4, K5 and K2 at the
   delta decode's cases (``sprintz_tpu_torch/probes/unpack_cases.py``: u8
   D 5-600 and u16 D 3-400, rows wider than a tile's shared memory, nb 1,
   31, 33, 70, 100 and 4101, MAXB cut inside the rows, all-zero-width
   blocks, a payload one byte off a 16-byte boundary);
2b. lowdim kernels (u8 D <= 4, u16 D <= 2), bit-exact against their
   plain versions: the lowdim decode (values) and its raw mode at
   ``unpack_cases.LOWDIM_CASES`` (every lowdim width, D 1-4 u8 and 1-2
   u16, nb 1-4101, runs, a misaligned payload), the lowdim encode pass
   from the rows and from errors at ``encode_cases.LOWDIM_PACK_CASES``
   (nb 1-4101: every width, all-zero and all-maximum blocks); FIRE with
   its full-precision coefficient at the ring shapes for those widths,
   from carried states whose counter wraps, and over a 32k-row stream a
   width (its plain version, a Python loop over blocks, runs once there);
   the encode pass (from the rows, and from FIRE's errors), the decode
   and its raw mode at the 4 MiB u8 d4 and u16 d2 streams;
2c. seekable kernels, bit-exact against their plain versions: FIRE's
   encode with its per-block states over the 8 MiB walks and the 32k-row
   lowdim streams; over the 8 MiB and 4 MiB walks, at the chunks and
   states of each stream's own sidecar (where they must give the stream)
   and from a sidecar with one state changed, the chunked FIRE decode
   (both coefficients: the sidecar's 16-group chunks on the short-chunk
   kernel, 1024-group chunks on the ring kernel) and the chunked delta
   decode (K1 then K2 with chunks, or the lowdim decode with them, also
   against the serial decode followed by the plain chunk seed); the same
   at the CPU tests' cuts (``host_build.FIRE_CASES`` and ``SHORT_CASES``,
   ``unpack_cases.SEED_CASES`` and ``CHUNK_CASES``: ragged and empty
   chunks, starts mid-tile and at tile and span edges); the chunked decode
   and the states' encode at the ring shapes with 1, 2, 7 and 33 chunks of
   unequal lengths from random states;
2e. FIRE's transform instantiations (``fire_encode`` / ``fire_decode`` with
   ``transform=True``: the xff transform's head), bit-exact against their
   plain version at the ring shapes of phase 2 (u8 and u16, D 1, 31, 33,
   129) and on a u8 stream (D 33) whose learning counter wraps;
3. main path: compress then decompress with device="cuda", every kernel's
   launch counter and every host entry point's call counter set to 0
   before that run and read after it (every kernel must have launched, and
   the host library's walk, row-major gather, plan, assembly and histogram
   must have been called): delta on the 8 MiB u8 and u16 random walks, the
   8 MiB runs stream and a 64 MiB u8 walk; FIRE (xff) on the 8 MiB u8 and
   u16 walks and the runs stream; +Huf with delta and with xff on the 8 MiB
   u8 walk, a smooth 8 MiB stream (steps in [-2, 2], where Huffman must
   win) and the 64 MiB u8 walk. After that run, K6 and huff_encode are
   held to their plain versions on each +Huf case's own sprintz stream at
   the chunk size the path used. Card bytes equal CPU bytes on a 1 MiB
   stream for delta, xff and xff+Huf; a +Huf container with an overrun
   chunk raises ``CorruptStreamError`` on the card; the reference-made
   vectors in tests/vectors, row-major and lowdim, decode and re-encode
   exactly;
3b. lowdim path, its counts set to 0 before it and read after it (every
   kernel of the lowdim path must have launched, K1 and K2 never, and the
   host library's walk, lowdim gather, plan, assembly and histogram must
   have been called; a delta encode and decode's device pass launch one
   kernel each): delta and xff on
   bench.py's lowdim stream (1M rows x 4 dims of a u8 walk, 4 MiB) and
   its u16 twin (1M x 2), and on u8 d1, d2, d3 and u16 d1 walks of 256k
   rows; delta on a d4 runs stream; delta+Huf on a d4 smooth stream,
   where the container must win (K6 and the encoder then held to their
   plain versions on its sprintz stream). Card bytes equal CPU bytes:
   delta on every whole stream, xff on each stream's first 32k rows;
3c. host: on every stream of both paths, for each codec the paths ran
   it with, the host library's walk, gather, plan and assembly equal their
   plain Python versions (the same arrays; the assembled bytes are the
   path's stream) and its histogram equals ``np.bincount``; each timed on
   the host's clock, the library's a median of 5 calls and the Python
   version's one call;
3d. seekable path, its counts set to 0 before it and read after it:
   ``compress_seekable``, ``decompress(sidecar=)`` and ``decode_range`` at
   three ranges on the 8 MiB u8 and u16 walks, the runs stream and the
   4 MiB u8 d4 and u16 d2 walks (delta and xff), the smooth stream
   (delta+Huf and xff+Huf) and the 64 MiB u8 walk (xff); every sidecar
   kernel must have launched (FIRE's short-chunk kernel for the sidecars,
   its ring kernel for ``decode_range``'s one chunk from row 0 to the
   stream's end; the delta decode's chunked modes) and FIRE's serial
   kernels never, the host library's parallel walk must have run, and
   every stream's bytes must be ``compress``'s; the sidecar's size is
   printed beside the stream's;
3e. batch, its counts set to 0 before it and read after it:
   ``SprintzCodec.compress_batch`` and ``decompress_batch`` on bench.py's
   xff-batch shape (512 streams x 256 rows x 64 dims of a u8 walk), its
   u16 twin (512 x 128 x 64), a lowdim batch (512 x 2048 x 4 u8) and 64
   runs streams (2048 x 64), delta and xff, and a mixed delta batch (a
   tail, a verbatim stream, another ndims); every batch kernel must have
   launched, the lowdim encode from the rows and FIRE's serial decode
   never; FIRE's encode launches once a batch and the decode is one
   ``decode_device``; every stream's bytes equal its own ``compress`` on
   the card and every decoded stream its input;
3f. query, its counts set to 0 before it and read after it:
   ``sprintz_tpu_torch.query`` on the 8 MiB u8 walk, the runs stream, an
   8 MiB u16 stream near 65535 (sums past 2^31) and the 4 MiB u8 d4 walk
   (delta: the compact pass) and the 8 MiB u8 walk under xff (the fused
   pass), every op with ``materialize`` True and False: results equal
   numpy over the raw data (sums wrapped to int32 on the device's share),
   paths as the JAX package picks them; the delta queries reduce in the
   epilogue of K2 or of the lowdim decode, and launch neither the plain K2
   nor the plain lowdim decode nor ``reduce_cols``, which the xff queries
   launch once an op and materialize flag (6); the NOOP queries (a decode)
   are counted apart. Then the epilogue kernels (K2's and the lowdim
   decode's REDUCE instantiations, ``csrc/decode.cu``) equal their plain
   versions on each delta stream at every op, store flag and gap setting
   (the data blocks with the runs' gaps and a leading run, the whole
   timeline without), and the standalone reduce (``csrc/query.cu``) equals
   its plain version on each stream's values, with and without the gaps;
3g. cli: ``python -m sprintz_tpu_torch`` compress, decompress, info and
   query in subprocesses on the 8 MiB u8 walk, delta and xff (with its
   sidecar): containers equal the API's bytes, the decoded files the raw
   one, info valid, sums numpy's;
3h. distribution (``sprintz_tpu_torch.parallel``), its counts set to 0
   before it and read after it: on meshes of 1, 2, 4 and 8 shards on the
   card (a shard a card, in turn, where there are several), over the 8 MiB
   u8 and u16 walks and the runs stream, ``dp_compress`` must write
   ``compress``'s bytes (delta and xff: the boundary row and FIRE's chain
   of carries across shards), and over those and the 4 MiB u8 d4 and u16
   d2 walks ``dp_decompress`` must give the input (delta's cross-shard
   prefix from K1's totals, FIRE's chain), and with each stream's sidecar
   (FIRE's shards from their checkpoints' states); ``dp_compress`` must
   raise at the lowdim ndims; ``dryrun_multichip(4, ["cuda:0"] * 4)``; every
   kernel of the path must have launched, and the host library's walks,
   gathers, plan and assembly been called. Then two processes over gloo
   sharing the card (``parallel/mp_check.py --large``, a timeout of their
   own): ``mp_compress`` from each one's slice equals ``compress`` and
   ``mp_decompress`` gives the input, delta and xff, u8 and u16, runs
   across the process boundary, the 8 MiB u8 walk;
3i. the other codec formats, each API call in a counting window of its own
   (the launches it must make, and no other): ``simple.compress_simple`` /
   ``decompress_simple`` with raw, delta and xff on the 8 MiB u8 and u16
   walks (bytes equal the port's plain CPU run, values the input; a raw
   decode launches K4 or K5 alone, a delta one K1 and K2, every encode K3);
   FIRE's transform instantiations against their plain version over the
   whole 8 MiB walks, at D 64 and at D 129 (the xff transform's head), the
   plain run on the host's CPU, timed once; ``transform_encode`` /
   ``transform_decode`` for every kind at D 64 (the walks as they are), 5
   and 129 (the same elements): values equal the input; delta and
   doubledelta launch nothing and equal their CPU run, xff launches the
   transform instantiations alone (never the codec's FIRE) and equals its
   plain version's bytes at D 64 and 129 and its CPU run on a 4096-row
   prefix at D 5; ``univariate.compress_univariate(method="sprintz")`` on a 4
   MiB 1-D u8 walk, delta and xff (the lowdim path at D 1; card bytes equal
   CPU bytes on a 32k prefix), and every host method (the nine legacy
   formats, dyndelta, sprintzpack, the nth-order deltas) on small u8 / u16
   walks;
3j. the off-codec modules, each API call in a counting window of its own:
   ``search`` at full width (X the 64 MiB u8 walk's 1M rows of 64 dims as
   float32 with duplicated rows planted, 1024 queries each moved by +-1 in
   3 dims): ``knn_batch`` (k 10), ``knn_tiled`` (tile 16384) and
   ``onenn_batch`` agree, equal a float64 brute force on 16 queries
   exactly (ties by the lower index), ``radius_batch`` equals numpy's lists
   on 64; all again with TF32 switched on globally (the same answers, the
   setting left as set, and a tile's distances unchanged where a bare
   matmul changes); ``squared_dists`` / ``knn_batch`` / ``knn_tiled``
   timed beside their bound; none launches a codec kernel. The
   filter-bank search (``models.learning``) at the reference's defaults
   (65536 candidates, chunk 4096, 65536 samples of the ``ucr_like``
   corpus) for l2, l1 and linf at block 1 and 8: each round's pick's
   objective within 1e-4 of a float64 recomputation and no sampled
   candidate better, and at a reduced grid the picks of the CPU run
   (the tests' rule); its rounds timed. ``frames.encode_measure_decode``
   on a 1M-row stand-in frame (no pandas) through chains of Quantize,
   Delta, Zigzag, CodecSearch, Zlib, DynamicDelta (64k rows), and
   ``Sprintz("delta")`` / ``Sprintz("xff")`` (the lowdim path at D 1):
   lossless, the Sprintz columns' bytes the CPU run's (xff on 32k rows).
   The five synthetic corpora at 100k rows, u8 and u16, through
   ``write_dat`` / ``read_dat`` and delta and xff on the card (either
   layout): lossless, delta's bytes the CPU run's, ratios printed.
   ``utils.timing.device_loop_time`` of K1's wrapper at the 8 MiB u8 walk
   (held in section 4 to 0.5-3x its CUDA-event median) and
   ``utils.trace.device_profile`` around a decompress of that walk in an
   ``annotate`` range: the trace names K1's and K2's kernels and the range;
4. timings: each kernel's wrapper, the time inside its kernel launches
   alone, its plain version and, where one exists, one PyTorch call of the
   same function, by CUDA events (median of 25 after warm-up, L2 flushed
   before each run; the plain FIRE is its one full-size run of phase 2,
   at the same size as the kernel's time), at the 8 MiB walks; also K3,
   K1 and K2 on the 64 MiB u8 walk, and K6 and huff_encode at chunk size
   4096 on the smooth 8 MiB stream's sprintz stream, whose plain decode (a Python
   loop of 4096 steps) is timed once. The FIRE rows also carry a
   chain bound: blocks x the dependent integer operations of a block,
   counted in csrc/fire.cu's header, x the latency of one dependent
   multiply-add, which a one-warp probe kernel measures on the card
   beside the SM clock. The lowdim rows: the encode pass (from the rows
   and from FIRE's errors), the decode and its raw mode at the 4 MiB u8
   d4 and u16 d2 streams, FIRE's full-coefficient kernels there (no plain
   time) and at the 32k-row streams (beside the plain version's one run).
   The sidecar rows: the chunked FIRE decode on both kernels (the
   sidecar's chunks, chunks of 1024 groups) beside the serial one, the
   states' encode beside the plain encode, the chunked delta decode's
   modes beside the serial kernels (nothing moves, and every chunk
   moved), at the 8 MiB and 4 MiB walks. Then compress
   and decompress end to end, split into host, H2D, device pass, kernels
   (the part of the device pass inside the kernel launches) and D2H, for
   delta, xff and +Huf, and for delta and xff on the 4 MiB lowdim streams
   (medians of 3 runs); then ``decompress(sidecar=)`` beside
   ``decompress`` and ``compress_seekable`` beside ``compress`` in turns,
   with both decodes' splits, on the xff walks and the 8 MiB u8 delta;
   the batch's FIRE encode at S * D lanes and its chunked (short-chunk)
   decode, the
   reduce kernel at each query stream and op (beside torch.sum / amax /
   amin), the epilogue K2 and lowdim decode at each delta query stream and
   op, with and without store, beside the plain K2 or lowdim decode
   followed by the reduce kernel, in turns; ``compress_batch`` and ``decompress_batch`` beside S single
   calls, with their host / H2D / device / D2H splits; ``query`` (sum,
   not materialized) beside ``decompress`` and numpy's sum, in turns;
   ``dp_compress`` and ``dp_decompress`` at 1, 4 and 8 shards beside
   ``compress`` and ``decompress``, in turns, with their host / H2D /
   device / D2H splits (L2 flushed, medians); FIRE's serial scans with
   their init and final carries beside the scans without, in turns; FIRE's
   transform instantiations at the 8 MiB walks (rows beside the codec's,
   chain bounds as theirs); ``compress_simple`` / ``decompress_simple``
   and ``transform_encode`` / ``transform_decode`` beside ``compress`` /
   ``decompress`` in turns (``[e2e simple]``, ``[e2e transform]``), with
   the simple codecs' device passes beside the RLE codec's.

The last two lines of standard output are the card's name and power limit
followed by ``{"ok": true, "device": {...}}``; the line before them is
``{"kernels": [...]}`` with every kernel. Data is made with numpy from a
fixed seed. Without a CUDA device, or without the package beside this
script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import socket
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
REPS = 25
E2E_REPS = 3
HOST_REPS = 5
# Peak rates for bound_ms (NVIDIA data sheets, dense, at full power).
# The data sheets list no int32 rate; the kernels' integer
# work is held against the float32 CUDA-core rate, a higher rate, so the
# ops bound stays a lower bound.
MEM_BYTES_PER_S = {"PCIe": 2.0e12, "NVL": 3.9e12}  # else SXM: 3.35e12
CORE_OPS_PER_S = 67e12
# integer operations per output element (per symbol for the Huffman
# kernels), counted from the kernels' source
OPS_PER_ELEM = {"unpack_zz": 12, "unpack_rows": 9, "unpack_rows_narrow": 9,
                "prefix_finish": 3, "pack_rows": 6, "fire_encode": 18,
                "fire_decode": 15, "huff_decode": 30, "huff_encode": 12,
                "encode_lowdim": 12, "encode_lowdim_errs": 9, "decode_lowdim": 12,
                "prefix_finish_reduce": 6, "decode_lowdim_reduce": 15,
                "unpack_lowdim_raw": 5,
                "fire_encode_full": 16, "fire_decode_full": 15,
                "fire_encode_transform": 18, "fire_decode_transform": 15}
# FIRE's serial chain: dependent integer operations a block, by elem_bits
# (the count is in csrc/fire.cu's header), and its tiling; the
# full-precision coefficient is one shift where the truncated one is three
CHAIN_OPS = {"fire_encode": {8: 15, 16: 14}, "fire_decode": {8: 16, 16: 20},
             "fire_encode_full": {8: 13, 16: 12},
             "fire_decode_full": {8: 14, 16: 18},
             # the preprocessor's: a shift more at u16 encode; at u16 decode
             # a multiply-high and a shift-add a row for the codec's shift
             # and multiply-add
             "fire_encode_transform": {8: 15, 16: 15},
             "fire_decode_transform": {8: 16, 16: 20}}
FIRE_TILE_BLOCKS = 16  # csrc/fire.cu TILE_BLOCKS
FIRE_STAGES = 8  # csrc/fire.cu STAGES: tiles in the ring
CHAIN_PROBE_ITERS = 1 << 20
KERNELS = {  # name -> (source, the TPU pass it replaces: file:line)
    "unpack_zz": ("sprintz_tpu_torch/csrc/decode.cu",
                  "sprintz_tpu/ops/pallas_decode.py:99"),
    "prefix_finish": ("sprintz_tpu_torch/csrc/decode.cu",
                      "sprintz_tpu/ops/pallas_decode.py:171"),
    "pack_rows": ("sprintz_tpu_torch/csrc/pack.cu",
                  "sprintz_tpu/ops/pallas_pack.py:242"),
    "unpack_rows": ("sprintz_tpu_torch/csrc/decode.cu",
                    "sprintz_tpu/ops/pallas_pack.py:75"),
    "unpack_rows_narrow": ("sprintz_tpu_torch/csrc/decode.cu",
                           "sprintz_tpu/ops/pallas_pack.py:192"),
    "huff_decode": ("sprintz_tpu_torch/csrc/huffman.cu",
                    "sprintz_tpu/entropy/pallas_huffman.py:216"),
    # the hand kernels of passes that JAX runs outside Pallas: an XLA
    # append scan and a lax.scan
    "huff_encode": ("sprintz_tpu_torch/csrc/huffman.cu",
                    "sprintz_tpu/entropy/huffman.py:736"),
    "fire_encode": ("sprintz_tpu_torch/csrc/fire.cu",
                    "sprintz_tpu/models/forecasters.py:303"),
    "fire_decode": ("sprintz_tpu_torch/csrc/fire.cu",
                    "sprintz_tpu/models/forecasters.py:303"),
    # the lowdim layout: fused XLA passes in JAX, and FIRE with its
    # full-precision coefficient (TRUNC false)
    "encode_lowdim": ("sprintz_tpu_torch/csrc/pack.cu",
                      "sprintz_tpu/encoder.py:132"),
    "encode_lowdim_errs": ("sprintz_tpu_torch/csrc/pack.cu",
                           "sprintz_tpu/ops/pack.py:251"),
    "decode_lowdim": ("sprintz_tpu_torch/csrc/decode.cu",
                      "sprintz_tpu/decoder.py:265"),
    "unpack_lowdim_raw": ("sprintz_tpu_torch/csrc/decode.cu",
                          "sprintz_tpu/ops/pack.py:683"),
    "fire_encode_full": ("sprintz_tpu_torch/csrc/fire.cu",
                         "sprintz_tpu/models/forecasters.py:303"),
    "fire_decode_full": ("sprintz_tpu_torch/csrc/fire.cu",
                         "sprintz_tpu/models/forecasters.py:303"),
    # the sidecar path: FIRE's decode vmapped over chunks from their states
    # (decoder._decode_pass_chunks), long chunks on the ring kernel, short
    # ones on the short-chunk kernel; the encode's second scan for its
    # states (fire_encode_with_states); and delta's decode vmapped over the
    # chunks, each from its state: K1, K2 and the lowdim decode with chunks
    "fire_decode_chunks": ("sprintz_tpu_torch/csrc/fire.cu",
                           "sprintz_tpu/decoder.py:949"),
    "fire_decode_chunks_full": ("sprintz_tpu_torch/csrc/fire.cu",
                                "sprintz_tpu/decoder.py:949"),
    "fire_decode_short": ("sprintz_tpu_torch/csrc/fire.cu",
                          "sprintz_tpu/decoder.py:949"),
    "fire_decode_short_full": ("sprintz_tpu_torch/csrc/fire.cu",
                               "sprintz_tpu/decoder.py:949"),
    "fire_encode_states": ("sprintz_tpu_torch/csrc/fire.cu",
                           "sprintz_tpu/models/forecasters.py:351"),
    "fire_encode_states_full": ("sprintz_tpu_torch/csrc/fire.cu",
                                "sprintz_tpu/models/forecasters.py:351"),
    "unpack_zz_chunks": ("sprintz_tpu_torch/csrc/decode.cu",
                         "sprintz_tpu/ops/pallas_decode.py:99"),
    "prefix_finish_chunks": ("sprintz_tpu_torch/csrc/decode.cu",
                             "sprintz_tpu/ops/pallas_decode.py:171"),
    "decode_lowdim_chunks": ("sprintz_tpu_torch/csrc/decode.cu",
                             "sprintz_tpu/decoder.py:945"),
    # query pushdown: the reduce that JAX runs in XLA after its decode
    # (jnp.sum in the fused pass), standalone (FIRE's fused pass) and as the
    # epilogue of K2 and of the lowdim decode (the compact pass's jnp.sum,
    # and the fused delta pass's)
    "reduce_cols": ("sprintz_tpu_torch/csrc/query.cu",
                    "sprintz_tpu/query/pushdown.py:84"),
    "prefix_finish_reduce": ("sprintz_tpu_torch/csrc/decode.cu",
                             "sprintz_tpu/query/pushdown.py:139"),
    "decode_lowdim_reduce": ("sprintz_tpu_torch/csrc/decode.cu",
                             "sprintz_tpu/query/pushdown.py:139"),
    # the standalone transforms' xff head: the same lax.scan with
    # transform=True (sprintz_tpu/transforms.py:96-113 calls it)
    "fire_encode_transform": ("sprintz_tpu_torch/csrc/fire.cu",
                              "sprintz_tpu/models/forecasters.py:303"),
    "fire_decode_transform": ("sprintz_tpu_torch/csrc/fire.cu",
                              "sprintz_tpu/models/forecasters.py:303"),
}
# the kernels each main path must launch: the row-major one and the lowdim
# one (u8 ndims <= 4, u16 ndims <= 2)
LOWDIM_PATH = {"encode_lowdim", "encode_lowdim_errs", "decode_lowdim",
               "unpack_lowdim_raw", "fire_encode_full", "fire_decode_full",
               "huff_decode", "huff_encode"}
# the host library's entry points each path must call
HOST_ROWMAJOR_PATH = {"walk_headers", "gather_blocks", "build_plan",
                      "assemble_stream", "histogram"}
HOST_LOWDIM_PATH = {"walk_headers", "gather_dims", "build_plan",
                    "assemble_stream", "histogram"}
ROWMAJOR_PATH = {"unpack_zz", "prefix_finish", "pack_rows", "unpack_rows",
                 "unpack_rows_narrow", "huff_decode", "huff_encode",
                 "fire_encode", "fire_decode"}
# the sidecar path (compress_seekable, decompress(sidecar=), decode_range)
# over both layouts: FIRE's encode writes its states, its decode runs in
# chunks (a sidecar's on the short-chunk kernel; decode_range's one chunk
# from row 0 to the stream's end on the ring kernel), and delta's decode
# runs K1 and K2, or the lowdim decode, with chunks
SEEKABLE_PATH = {"pack_rows", "unpack_rows", "unpack_rows_narrow",
                 "huff_decode", "huff_encode", "encode_lowdim",
                 "encode_lowdim_errs", "unpack_lowdim_raw",
                 "fire_encode_states", "fire_encode_states_full",
                 "fire_decode_chunks", "fire_decode_chunks_full",
                 "fire_decode_short", "fire_decode_short_full",
                 "unpack_zz_chunks", "prefix_finish_chunks",
                 "decode_lowdim_chunks"}
HOST_SEEKABLE_PATH = HOST_ROWMAJOR_PATH | HOST_LOWDIM_PATH | {
    "walk_headers_parallel"}
# the batch path (compress_batch, decompress_batch) over both layouts and
# codecs: FIRE's encode over S * D lanes, its decode in chunks (a chunk a
# stream: short ones on the short-chunk kernel, the runs batch's 2048-row
# streams on the ring kernel), delta's decode with chunks (K1 and K2
# serial for the mixed batch's stream of another ndims)
BATCH_PATH = {"unpack_zz", "prefix_finish", "pack_rows", "unpack_rows",
              "unpack_rows_narrow", "encode_lowdim_errs", "unpack_lowdim_raw",
              "fire_encode", "fire_encode_full", "fire_decode_chunks",
              "fire_decode_short", "fire_decode_short_full",
              "unpack_zz_chunks", "prefix_finish_chunks",
              "decode_lowdim_chunks"}
# query pushdown: the compact delta pass (both layouts: K1 and K2 with the
# reduce as its epilogue, or the lowdim decode with it), the fused xff pass
# (u8: K5 and FIRE's serial decode, then the standalone reduce)
QUERY_PATH = {"unpack_zz", "prefix_finish_reduce", "decode_lowdim_reduce",
              "unpack_rows_narrow", "fire_decode", "reduce_cols"}
# the queries that must not launch these: every delta query with an op
QUERY_NEVER = {"prefix_finish", "decode_lowdim"}
# distribution: the sharded encode (delta's boundary row, FIRE's chain of
# carries, K3), the sharded decode (K1's totals and K2, the lowdim decode;
# K4/K5 or the lowdim raw mode and FIRE's serial decode a shard; a
# sidecar's chunks on the short-chunk kernel) and the dry run's +Huf
DIST_PATH = {"unpack_zz", "prefix_finish", "pack_rows", "unpack_rows",
             "unpack_rows_narrow", "fire_encode", "fire_decode",
             "decode_lowdim", "unpack_lowdim_raw", "fire_decode_full",
             "fire_decode_short", "fire_decode_short_full", "huff_encode",
             "huff_decode"}
# the other codec formats (phase 3i): the kernels each call must launch,
# and no other. The non-RLE codecs (simple.py): every encode K3 (xff after
# FIRE), a raw decode K5 (u8) or K4 (u16) alone, a delta decode K1 and K2,
# an xff decode K5 / K4 and FIRE; the transforms: xff's head on FIRE's
# transform instantiations alone, delta and doubledelta on none; the
# univariate "sprintz" method, the lowdim path at D 1
SIMPLE_CALLS = {
    ("raw", 1, "encode"): {"pack_rows"}, ("raw", 2, "encode"): {"pack_rows"},
    ("raw", 1, "decode"): {"unpack_rows_narrow"},
    ("raw", 2, "decode"): {"unpack_rows"},
    ("delta", 1, "encode"): {"pack_rows"}, ("delta", 2, "encode"): {"pack_rows"},
    ("delta", 1, "decode"): {"unpack_zz", "prefix_finish"},
    ("delta", 2, "decode"): {"unpack_zz", "prefix_finish"},
    ("xff", 1, "encode"): {"fire_encode", "pack_rows"},
    ("xff", 2, "encode"): {"fire_encode", "pack_rows"},
    ("xff", 1, "decode"): {"unpack_rows_narrow", "fire_decode"},
    ("xff", 2, "decode"): {"unpack_rows", "fire_decode"}}
TRANSFORM_CALLS = {"xff encode": {"fire_encode_transform"},
                   "xff decode": {"fire_decode_transform"}}
UNIVARIATE_CALLS = {("delta", "encode"): {"encode_lowdim"},
                    ("delta", "decode"): {"decode_lowdim"},
                    ("xff", "encode"): {"fire_encode_full", "encode_lowdim_errs"},
                    ("xff", "decode"): {"unpack_lowdim_raw", "fire_decode_full"}}
FORMATS_PATH = set().union(*SIMPLE_CALLS.values(), *TRANSFORM_CALLS.values(),
                           *UNIVARIATE_CALLS.values())
HOST_METHODS = ("delta_simple8b", "delta8b", "online8b", "delta_online8b",
                "delta2_online8b", "delta_rle8b", "delta_rle28b",
                "doubledelta8b", "dyndelta8b", "dyndelta", "sprintzpack",
                "delta", "doubledelta", "tripledelta")
# the off-codec modules (phase 3j): a frame's Sprintz columns and the
# corpora take the codec's paths (the lowdim one at D 1, both layouts for
# the corpora); search and the filter-bank search launch none of these
OFFCODEC_PATH = set().union(
    *UNIVARIATE_CALLS.values(),
    *(SIMPLE_CALLS[(c, es, s)] for c in ("delta", "xff") for es in (1, 2)
      for s in ("encode", "decode")))
SEARCH_TILE = 16384  # knn_tiled's default row tile
RADIUS_SQ = 1500.0  # about two walk steps in 64 dims: a few rows a query
HOST_DIST_PATH = {"walk_headers", "walk_headers_parallel", "gather_blocks",
                  "gather_dims", "build_plan", "assemble_stream"}
DIST_SHARDS = (1, 2, 4, 8)
MP_TIMEOUT_S = 600  # the two-rank phase's own limit
BATCH_REPS = 3
EVERY_GROUPS = 16  # the sidecar's default: a checkpoint every 16 groups
LOWDIM_ROWS = 1 << 20  # bench.py's extra_lowdim: 1M rows (bench.py:451-479)
LOWDIM_SMALL_ROWS = 1 << 18
FIRE_PLAIN_ROWS = 1 << 15  # where the plain FIRE (a Python loop) is affordable
HUFF_CS = 128  # bench.py's chunk size for the Huffman kernel rows
DEC_LONG_CS = 20000  # a chunk longer than K6's window of payload


def log(msg: str) -> None:
    print(msg, flush=True)


def walk_stream(rng, nrows: int, ndims: int, elem_sz: int) -> np.ndarray:
    """bench.py's headline family: a random walk with steps in [-6, 6]."""
    hi = 1 << (8 * elem_sz)
    return (np.cumsum(rng.integers(-6, 7, (nrows, ndims)), axis=0) % hi
            ).astype(np.uint8 if elem_sz == 1 else np.uint16)


def smooth_stream(rng, nrows: int, ndims: int) -> np.ndarray:
    """tests/test_huffman.py's +Huf family: steps in [-2, 2], whose sprintz
    stream Huffman coding shrinks."""
    return (np.cumsum(rng.integers(-2, 3, (nrows, ndims)), axis=0) % 256
            ).astype(np.uint8)


def runs_stream(rng, nrows: int, ndims: int) -> np.ndarray:
    """bench.py's runs family: every third 256-row segment is constant."""
    seg = rng.integers(-6, 7, (nrows, ndims))
    m = (np.arange(nrows) // 256 % 3 == 0)[:, None]
    return (np.cumsum(np.where(m, 0, seg), axis=0) % 256).astype(np.uint8)


class Frame:
    """A stand-in DataFrame for the frames phase: ``.columns`` and
    ``frame[c].to_numpy()`` over a dict of numpy columns (no pandas)."""

    class Column:
        def __init__(self, values: np.ndarray):
            self.values = values
            self.dtype = values.dtype

        def to_numpy(self) -> np.ndarray:
            return self.values

    def __init__(self, cols: dict):
        self.cols = cols
        self.columns = list(cols)

    def __getitem__(self, c):
        return self.Column(self.cols[c])


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        import sprintz_tpu_torch
        from sprintz_tpu_torch import (SprintzCodec, checkpoint, decoder,
                                       encoder, native_host, planner, simple,
                                       transforms, univariate)
        from sprintz_tpu_torch.entropy import huffman as hf
        from sprintz_tpu_torch.models import forecasters as fc
        from sprintz_tpu_torch.ops import _build
        from sprintz_tpu_torch.ops import decode_kernels as dk
        from sprintz_tpu_torch.ops import huffman_kernels as hk
        from sprintz_tpu_torch.ops import pack_kernels as pk
        from sprintz_tpu_torch.ops import query_kernels as qk
        from sprintz_tpu_torch import query as tquery
        from sprintz_tpu_torch.constants import LOWDIM_MAX_NDIMS
        from sprintz_tpu_torch.ops.bitmath import block_widths_rowmajor
        from sprintz_tpu_torch.parallel import dryrun as pdry
        from sprintz_tpu_torch.parallel import shard as pshard
        from sprintz_tpu_torch.planner import build_plan
        from sprintz_tpu_torch.errors import CorruptStreamError
        from sprintz_tpu_torch.probes import decode_cases as dc
        from sprintz_tpu_torch.probes import encode_cases as ec
        from sprintz_tpu_torch.probes import unpack_cases as uc
        from sprintz_tpu_torch.probes.host_build import (
            FIRE_CASES, SHORT_CASES, chunk_cuts, chunk_states, short_case,
            wrapping_transform_rows)
        from sprintz_tpu_torch.stream_format import read_metadata_rle
        from sprintz_tpu_torch import frames as tframes
        from sprintz_tpu_torch import search as tsearch
        from sprintz_tpu_torch.data import corpus as tcorpus
        from sprintz_tpu_torch.device import exact_fp32_matmul
        from sprintz_tpu_torch.frames import codecs as fcodecs
        from sprintz_tpu_torch.models import learning as tlearn
        from sprintz_tpu_torch.utils import timing as ttiming
        from sprintz_tpu_torch.utils import trace as ttrace
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    here = pathlib.Path(__file__).resolve().parent
    if pathlib.Path(sprintz_tpu_torch.__file__).resolve().parent.parent != here:
        print("chip_smoke: sprintz_tpu_torch is not the checkout's own "
              f"({sprintz_tpu_torch.__file__})", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    mem_rate = next((r for k, r in MEM_BYTES_PER_S.items() if k in kind),
                    3.35e12)
    # kernel name -> (wrapper, attribute holding its launch count)
    counters = {
        "unpack_zz": (dk.unpack_zz, "launches"),
        "prefix_finish": (dk.prefix_finish, "launches"),
        "pack_rows": (pk.pack_rows, "launches"),
        "unpack_rows": (pk.unpack_rows, "launches"),
        "unpack_rows_narrow": (pk.unpack_rows, "narrow_launches"),
        "huff_decode": (hk.decode_chunks, "launches"),
        "huff_encode": (hk.encode_chunks, "launches"),
        "fire_encode": (fc.fire_encode, "launches"),
        "fire_decode": (fc.fire_decode, "launches"),
        "encode_lowdim": (pk.encode_lowdim, "launches"),
        "encode_lowdim_errs": (pk.encode_lowdim, "errs_launches"),
        "decode_lowdim": (dk.decode_delta_lowdim, "launches"),
        "unpack_lowdim_raw": (dk.unpack_dims_lowdim, "launches"),
        "fire_encode_full": (fc.fire_encode, "full_launches"),
        "fire_decode_full": (fc.fire_decode, "full_launches"),
        "fire_decode_chunks": (fc.fire_decode_chunks, "launches"),
        "fire_decode_chunks_full": (fc.fire_decode_chunks, "full_launches"),
        "fire_decode_short": (fc.fire_decode_chunks, "short_launches"),
        "fire_decode_short_full": (fc.fire_decode_chunks,
                                   "short_full_launches"),
        "fire_encode_states": (fc.fire_encode, "states_launches"),
        "fire_encode_states_full": (fc.fire_encode, "states_full_launches"),
        "unpack_zz_chunks": (dk.unpack_zz, "chunk_launches"),
        "prefix_finish_chunks": (dk.prefix_finish, "chunk_launches"),
        "decode_lowdim_chunks": (dk.decode_delta_lowdim, "chunk_launches"),
        "reduce_cols": (qk.reduce_cols, "launches"),
        "prefix_finish_reduce": (qk.prefix_finish_reduce, "launches"),
        "decode_lowdim_reduce": (qk.decode_lowdim_reduce, "launches"),
        "fire_encode_transform": (fc.fire_encode, "transform_launches"),
        "fire_decode_transform": (fc.fire_decode, "transform_launches"),
    }
    assert set(counters) == set(KERNELS) == (LOWDIM_PATH | ROWMAJOR_PATH
                                             | SEEKABLE_PATH | BATCH_PATH
                                             | QUERY_PATH | DIST_PATH
                                             | FORMATS_PATH)

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s: "
        + ", ".join(p.name for p in libs.values()))
    for p in libs.values():
        ptxas = p.with_suffix(".log")
        if ptxas.exists():
            print(ptxas.read_text(), file=sys.stderr)
    t0 = time.perf_counter()
    host_lib = native_host.build()
    gxx = subprocess.run([native_host._gxx(), "--version"], check=True,
                         capture_output=True, text=True, timeout=60)
    log(f"[build] host library {time.perf_counter() - t0:.1f} s: "
        f"{host_lib.name}, by {gxx.stdout.splitlines()[0]} with "
        + " ".join(native_host.GXX_FLAGS))

    def zero_counts():
        """Every kernel's launch count and every host entry point's call
        count set to 0."""
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        for fn in native_host.ENTRY_POINTS:
            fn.calls = 0

    def host_calls(what: str, needed: set) -> dict:
        """The host entry points' call counts; raise if one the path needs
        was never called."""
        calls = {fn.__name__: fn.calls for fn in native_host.ENTRY_POINTS}
        log(f"[{what}] host calls: {json.dumps(calls)}")
        missing = sorted(k for k in needed if calls[k] == 0)
        if missing:
            raise AssertionError(f"{what} path never called the host "
                                 f"library's {missing}")
        return calls

    # -------------------------------------------------------- 2. kernels
    rng = np.random.default_rng(SEED)

    max_err = {k: 0 for k in KERNELS}

    def once_ms(fn):
        """fn's result and the card time of its one run (CUDA events)."""
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        e.synchronize()
        return out, s.elapsed_time(e)

    def check(name, got, want, what):
        torch.cuda.synchronize()
        if isinstance(got, tuple):
            for g, w in zip(got, want):
                check(name, g, w, what)
            return
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name} {what}: {got.shape}/{got.dtype} "
                                 f"vs plain {want.shape}/{want.dtype}")
        err = int((dk.widen(got).long() - dk.widen(want).long()).abs().max()
                  ) if got.numel() else 0
        max_err[name] = max(max_err[name], err)
        if err:
            raise AssertionError(f"{name} {what}: max |kernel - plain| = {err}")

    def kernel_inputs(x: np.ndarray, elem_sz: int):
        """Device inputs of every row-major kernel, from stream x as the
        path makes them: encode side (errs, widths; the rows and FIRE's
        errors) and decode side (dense with the real stream's MAXB,
        widths, biased deltas, tile offsets)."""
        eb = 8 * elem_sz
        nd = x.shape[1]
        rows = encoder.upload_rows(x, dev)
        blocks = fc.delta_encode(rows, eb).reshape(-1, 8, nd)
        widths = block_widths_rowmajor(blocks.amax(dim=1), elem_sz)
        buf = encoder.compress(x.reshape(-1), nd, device=dev)
        ng, _, _ = read_metadata_rle(buf)
        idx = decoder.walk_headers(buf, ng, nd, elem_sz)
        dense, dwidths, _ = decoder.upload_payload(
            decoder.gather_payloads(buf, idx), idx, dev)
        bz, toff = dk.unpack_zz_plain(dense, dwidths, eb)
        ferrs = fc.fire_encode(rows, eb)
        return dict(blocks=blocks, widths=widths, dense=dense,
                    dwidths=dwidths, bz=bz.reshape(-1, nd),
                    toff=toff, eb=eb, es=elem_sz,
                    rows=rows, ferrs=ferrs.to(torch.uint8) if eb == 8
                    else ferrs)

    shapes = {
        "u8 main (nb 16384, D 64)": walk_stream(rng, 1 << 17, 64, 1),
        "u16 main (nb 8192, D 64)": walk_stream(rng, 1 << 16, 64, 2),
        "u8 ragged (nb 4101, D 129)": walk_stream(rng, 4101 * 8, 129, 1),
        "u16 ragged (nb 4101, D 129)": walk_stream(rng, 4101 * 8, 129, 2),
    }
    inputs = {}
    for what, x in shapes.items():
        a = inputs[what] = kernel_inputs(x, x.dtype.itemsize)
        eb, es = a["eb"], a["es"]
        check("pack_rows", pk.pack_rows(a["blocks"], a["widths"], es),
              pk.pack_rows_plain(a["blocks"], a["widths"], es), what)
        check("unpack_zz", dk.unpack_zz(a["dense"], a["dwidths"], eb),
              dk.unpack_zz_plain(a["dense"], a["dwidths"], eb), what)
        check("unpack_rows", pk.unpack_rows(a["dense"], a["dwidths"]),
              pk.unpack_rows_plain(a["dense"], a["dwidths"]), what)
        if es == 1:
            check("unpack_rows_narrow",
                  pk.unpack_rows(a["dense"], a["dwidths"], narrow=True),
                  pk.unpack_rows_plain(a["dense"], a["dwidths"], True), what)
        check("prefix_finish", dk.prefix_finish(a["bz"], a["toff"], eb),
              dk.prefix_finish_plain(a["bz"], a["toff"], eb), what)
        # FIRE over the whole stream, so that the counter's and the
        # coefficient's wraps far into a stream are held too; its plain
        # version loops over blocks in Python, so it runs once, and that
        # run is its plain_ms.
        # The plain runs also give the final carry, which the kernels' init
        # and final pointers are held to (the sharded scans' chain).
        r, fe = a["rows"], a["ferrs"]
        want_e, ms_e = once_ms(lambda: fc.fire_encode_plain(r, eb,
                                                            final=True))
        check("fire_encode", fc.fire_encode(r, eb), want_e[0], what)
        check("fire_encode", fc.fire_encode(r, eb, final=True), want_e,
              what + ", its final carry")
        want_d, ms_d = once_ms(lambda: fc.fire_decode_plain(fe, eb,
                                                            final=True))
        check("fire_decode", fc.fire_decode(fe, eb), want_d[0], what)
        check("fire_decode", fc.fire_decode(fe, eb, final=True), want_d,
              what + ", its final carry")
        half = 1 << (eb - 1)  # a carried state: a value, a delta, a counter
        state = torch.stack([r[1], ((r[1] - r[0] + half) & (2 * half - 1))
                             - half, r[2] * 37]).contiguous()
        check("fire_decode", fc.fire_decode(fe, eb, state, final=True),
              fc.fire_decode_plain(fe, eb, state, final=True),
              what + ", a carried state in and out")
        a["fire_plain_ms"] = {"fire_encode": ms_e, "fire_decode": ms_d}
        # the stream's data blocks: an odd last block goes to the verbatim
        # tail, since blocks are coded in groups of two
        vals = dk.decode_delta_contiguous(a["dense"], a["dwidths"], eb)
        torch.cuda.synchronize()
        if not np.array_equal(decoder.download_values(vals),
                              x[: vals.shape[0]].reshape(-1)):
            raise AssertionError(f"decode_delta_contiguous {what}: values "
                                 f"differ from the input")
        log(f"[kernels] {what}: MAXB {a['dense'].shape[2]}, every row-major "
            f"kernel equals its plain version (FIRE at {r.shape[0] // 8} "
            f"blocks; its plain encode {ms_e:.1f} ms, decode {ms_d:.1f} ms)")

    def check_fire(what, vals, eb, state=None, errs=None, trunc=True):
        """FIRE encode (from the zero state, and from `state` with its final
        carry) and decode (from the zero state and from `state`, with its
        final carry) against their plain versions on the (N, D) int32
        values `vals`; `errs`: the errors to decode, else the encoder's.
        trunc: the truncated coefficient (row-major) or the full one
        (lowdim, the kernels' `_full` rows)."""
        sfx = "" if trunc else "_full"
        t = torch.from_numpy(vals).to(dev)
        got = fc.fire_encode(t, eb, truncate_coeffs=trunc)
        check("fire_encode" + sfx, got,
              fc.fire_encode_plain(t, eb, truncate_coeffs=trunc), what)
        if state is not None:
            check("fire_encode" + sfx,
                  fc.fire_encode(t, eb, trunc, init_state=state, final=True),
                  fc.fire_encode_plain(t, eb, trunc, init_state=state,
                                       final=True),
                  what + ", carried in and out")
        zz = got if errs is None else errs
        zz = zz.to(torch.uint8) if eb == 8 else zz
        for st in (None, state):
            check("fire_decode" + sfx,
                  fc.fire_decode(zz, eb, st, truncate_coeffs=trunc,
                                 final=True),
                  fc.fire_decode_plain(zz, eb, st, truncate_coeffs=trunc,
                                       final=True),
                  what)
        return fc.fire_decode(zz, eb, state, truncate_coeffs=trunc)

    # the shapes that stress the ring: a stream of one block, one block
    # less and more than a tile, fewer tiles than the ring, more than the
    # ring; one dim, ragged groups of 32, u8 rows that no copy could align
    ring_blocks = FIRE_TILE_BLOCKS * FIRE_STAGES
    nchecked = 0
    for eb in (8, 16):
        half = 1 << (eb - 1)
        for nb in (1, FIRE_TILE_BLOCKS - 1, FIRE_TILE_BLOCKS + 1,
                   ring_blocks // 3, ring_blocks + 1):
            for nd in (1, 31, 33, 129):
                vals = walk_stream(rng, nb * 8, nd, eb // 8).astype(np.int32)
                if nb == ring_blocks // 3:  # every delta, no forecast holds
                    vals = rng.integers(0, 2 * half, vals.shape
                                        ).astype(np.int32)
                # a carried value, delta and counter; at one length a
                # delta wider than its element, which the reference takes
                wide = 1 << 20 if nb == FIRE_TILE_BLOCKS + 1 else half
                state = torch.from_numpy(np.stack([
                    rng.integers(0, 2 * half, nd),
                    rng.integers(-wide, wide, nd),
                    rng.integers(-(1 << 15), 1 << 15, nd)]).astype(np.int32))
                check_fire(f"FIRE u{eb} nb {nb} D {nd}", vals, eb, state)
                nchecked += 1
    log(f"[kernels] FIRE equals its plain version at {nchecked} ring shapes "
        f"(tiles of {FIRE_TILE_BLOCKS} blocks, a ring of {FIRE_STAGES})")

    # carried states whose counter wraps inside the stream: steady streams
    # drive the counter up from 100 blocks below its top (16 bits at u8, 32
    # at u16); from the zero state the u16 counter passes 2^16, where the
    # coefficient wraps. The errors are the line-by-line plain version's
    # from that state, so the decode must return the stream.
    for eb in (8, 16):
        nb, nd = 300, 33
        steps = (np.tile([1, 127], nb * 4) if eb == 8
                 else np.full(nb * 8, 8000))
        vals = (np.cumsum(steps) % (1 << eb)).astype(np.int32)[:, None
                                                               ].repeat(nd, 1)
        state = np.zeros((3, nd), np.int32)
        top = (1 << 15) - 1 if eb == 8 else (1 << 31) - 1
        state[2] = top - 100 * (1 if eb == 8 else 8000)
        state = torch.from_numpy(state)
        errs = fc._fire_scan_plain(
            torch.from_numpy(vals).to(dev).long().reshape(nb, 8, nd), eb,
            False, state).reshape(nb * 8, nd).to(torch.int32)
        out = check_fire(f"FIRE u{eb} counter wrap", vals, eb, state, errs)
        if not np.array_equal(dk.widen(out).cpu().numpy(), vals):
            raise AssertionError(f"FIRE u{eb} counter wrap: decode from the "
                                 f"carried state differs from the stream")
    log("[kernels] FIRE equals its plain version across the counter's and "
        "the coefficient's wraps")

    # 2e. FIRE's transform instantiations at the ring shapes and on a u8
    # stream whose learning counter wraps (their whole-stream check is in
    # phase 3i, on its streams); a generator of their own, so that the
    # main path's streams stay bench.py's
    t_phase = time.perf_counter()
    xrng = np.random.default_rng(SEED + 16)

    def transform_raw(errs: torch.Tensor, eb: int) -> torch.Tensor:
        """The transform encode's errors as a stream stores them: uint8,
        or u16 as int16."""
        if eb == 8:
            return errs.to(torch.uint8)
        return (errs - ((errs & 0x8000) << 1)).to(torch.int16)

    def check_transform(what, vals, eb):
        """The transform encode and decode against their plain versions on
        (N, D) int32 values on the card; the decode must give them back."""
        want = fc.fire_encode_plain(vals, eb, transform=True)
        check("fire_encode_transform", fc.fire_encode(vals, eb, transform=True),
              want, what)
        raw = transform_raw(want, eb)
        got = fc.fire_decode(raw, eb, transform=True)
        check("fire_decode_transform", got,
              fc.fire_decode_plain(raw, eb, transform=True), what)
        if not torch.equal(dk.widen(got), vals):
            raise AssertionError(f"FIRE transform {what}: the decode does not "
                                 f"give the values back")

    nxf = 0
    for eb in (8, 16):
        for nb in (1, FIRE_TILE_BLOCKS - 1, FIRE_TILE_BLOCKS + 1,
                   ring_blocks // 3, ring_blocks + 1):
            for nd in (1, 31, 33, 129):
                vals = walk_stream(xrng, nb * 8, nd, eb // 8).astype(np.int32)
                if nb == ring_blocks // 3:  # every delta, no forecast holds
                    vals = xrng.integers(0, 1 << eb, vals.shape
                                         ).astype(np.int32)
                check_transform(f"u{eb} nb {nb} D {nd}",
                                torch.from_numpy(vals).to(dev), eb)
                nxf += 1
    check_transform("u8 counter wrap (nb 1100, D 33)", torch.from_numpy(
        wrapping_transform_rows(8, 33, 1100)).to(dev), 8)
    log(f"[kernels] FIRE's transform instantiations equal their plain "
        f"version at {nxf} ring shapes and across the u8 counter's wrap; "
        f"{time.perf_counter() - t_phase:.1f} s")

    def huff_inputs(data: np.ndarray, cs: int):
        """Device inputs of both Huffman kernels for the bytes ``data``: the
        container coded at chunk size cs, as huff_decompress uploads it, and
        the symbols and code tables, as huff_compress uploads them."""
        buf = hf.huff_compress(data, chunk_symbols=cs, allow_stored=False,
                               device=dev)
        n, cs, nchunks, t, sizes, offsets = hf._parse(buf)
        dec = dc.decode_inputs(buf, dev)
        enc = (hf.upload_bytes(data, dev), *hf.encode_table(t, dev), cs)
        return dict(buf=buf, dec=dec, enc=enc, n=n, nchunks=nchunks,
                    payload=len(buf) - int(offsets[0]))

    def check_huff(what: str, data: np.ndarray, cs: int) -> dict:
        """K6 and the encoder against their plain versions on the bytes
        ``data`` coded at chunk size cs; K6's symbols equal the data, and
        no chunk is flagged."""
        h = huff_inputs(data, cs)
        out = hk.decode_chunks(*h["dec"])
        check("huff_decode", out, hk.decode_chunks_plain(*h["dec"]), what)
        syms, nbad = hk.split_decoded(out, h["n"])
        if not np.array_equal(syms.cpu().numpy(), data) or int(nbad):
            raise AssertionError(f"huff_decode {what}: symbols differ from "
                                 f"the data, or {int(nbad)} chunks flagged")
        check("huff_encode", hk.encode_chunks(*h["enc"]),
              hk.encode_chunks_plain(*h["enc"]), what)
        log(f"[kernels] {what}: {h['nchunks']} chunks, huff_decode and "
            f"huff_encode equal their plain versions")
        return h

    headline = np.frombuffer(sprintz_tpu_torch.compress(
        shapes["u8 main (nb 16384, D 64)"], device="cuda"), np.uint8)
    small = np.frombuffer(sprintz_tpu_torch.compress(
        walk_stream(rng, 1 << 12, 64, 1), device="cuda"), np.uint8)
    huff = {}
    for what, data, cs in (
            (f"headline sprintz stream ({headline.size} B, cs {HUFF_CS})",
             headline, HUFF_CS),
            (f"small sprintz stream ({small.size} B, cs 4096)", small, 4096)):
        huff[what] = check_huff(what, data, cs)

    # the encode side's edge shapes, the CPU tests' list (from a generator
    # of their own, so that the streams below stay those of earlier runs)
    erng = np.random.default_rng(SEED + 1)
    for nd, es in ec.PACK_CASES:
        errs, widths = (torch.from_numpy(t).to(dev)
                        for t in ec.pack_case(erng, nd, es))
        check("pack_rows", pk.pack_rows(errs, widths, es),
              pk.pack_rows_plain(errs, widths, es),
              f"edge shape nb {errs.shape[0]} D {nd} u{8 * es}")
    for cs, stream in ec.HUFF_CASES:
        data, t = ec.huff_case(erng, cs, stream)
        enc = (hf.upload_bytes(data, dev), *hf.encode_table(
            hf.build_table(data) if t is None else t, dev), cs)
        check("huff_encode", hk.encode_chunks(*enc),
              hk.encode_chunks_plain(*enc),
              f"edge shape cs {cs} {stream} ({data.size} symbols)")
    log(f"[kernels] pack_rows at {len(ec.PACK_CASES)} and huff_encode at "
        f"{len(ec.HUFF_CASES)} edge shapes equal their plain versions")
    # the decode side's cases, the CPU tests' list: K6's symbols and
    # overrun count against its plain version's; then one case at a chunk
    # size above a CTA's window of payload (its plain version runs once)
    drng = np.random.default_rng(SEED + 2)
    for cs, case in dc.DECODE_CASES + [(DEC_LONG_CS, "ragged")]:
        buf, data, nbad = dc.decode_case(drng, cs, case)
        args = dc.decode_inputs(buf, dev)
        out = hk.decode_chunks(*args)
        check("huff_decode", out, hk.decode_chunks_plain(*args),
              f"decode case cs {cs} {case}")
        got_bad = int(hk.split_decoded(out, data.size)[1])
        if got_bad != nbad:
            raise AssertionError(f"huff_decode cs {cs} {case}: {got_bad} "
                                 f"chunks flagged, want {nbad}")
    log(f"[kernels] huff_decode at {len(dc.DECODE_CASES)} decode cases and "
        f"at cs {DEC_LONG_CS} equals its plain version, symbols and flags")
    # the delta decode's cases, the CPU tests' list: K1 (deltas and tile
    # offsets), K4, K5 (u8) and K2 on K1's output
    urng = np.random.default_rng(SEED + 4)
    for eb, nd, nb, ukind in uc.UNPACK_CASES:
        d, w = uc.to_device(*uc.unpack_case(urng, eb, nd, nb, ukind)[:2],
                            ukind, dev)
        what = f"unpack case u{eb} D {nd} nb {nb} {ukind}"
        bz, toff = dk.unpack_zz(d, w, eb)
        check("unpack_zz", (bz, toff), dk.unpack_zz_plain(d, w, eb), what)
        check("unpack_rows", pk.unpack_rows(d, w),
              pk.unpack_rows_plain(d, w), what)
        if eb == 8:
            check("unpack_rows_narrow", pk.unpack_rows(d, w, narrow=True),
                  pk.unpack_rows_plain(d, w, True), what)
        bz = bz.reshape(-1, nd)
        check("prefix_finish", dk.prefix_finish(bz, toff, eb),
              dk.prefix_finish_plain(bz, toff, eb), what)
    log(f"[kernels] unpack_zz, unpack_rows, unpack_rows_narrow and "
        f"prefix_finish at {len(uc.UNPACK_CASES)} unpack cases equal their "
        f"plain versions")

    # ---------------------------------------------- 2b. lowdim kernels
    # The lowdim layout's cases, the CPU tests' lists: both modes of the
    # lowdim decode (D 1-4 u8, 1-2 u16), the encode pass from the rows and
    # from errors; then FIRE with its full-precision coefficient at the
    # ring shapes, from wrapping states and over a 32k-row stream a width;
    # then the encode and decode at the full-size streams. A generator of
    # its own, so that the streams of the other phases stay those of
    # earlier runs.
    lrng = np.random.default_rng(SEED + 5)
    for eb, nd, nb, ukind in uc.LOWDIM_CASES:
        d, w = uc.to_device(*uc.lowdim_case(lrng, eb, nd, nb, ukind)[:2],
                            ukind, dev)
        what = f"lowdim case u{eb} D {nd} nb {nb} {ukind}"
        check("decode_lowdim", dk.decode_delta_lowdim(d, w, eb),
              dk.decode_delta_lowdim_plain(d, w, eb), what)
        check("unpack_lowdim_raw", dk.unpack_dims_lowdim(d, w),
              dk.unpack_dims_lowdim_plain(d, w), what)
    for nd, es, nb in ec.LOWDIM_PACK_CASES:
        rows, errs = ec.lowdim_rows_case(lrng, nd, es, nb)
        rows, errs = ec.rows_tensor(rows).to(dev), torch.from_numpy(errs).to(dev)
        what = f"lowdim encode case nb {nb} D {nd} u{8 * es}"
        check("encode_lowdim", pk.encode_lowdim(rows, es),
              pk.encode_lowdim_plain(rows, es), what)
        check("encode_lowdim_errs", pk.encode_lowdim(errs, es, errors=True),
              pk.encode_lowdim_plain(errs, es, errors=True), what)
    log(f"[kernels] decode_lowdim and unpack_lowdim_raw at "
        f"{len(uc.LOWDIM_CASES)} lowdim cases, encode_lowdim from the rows "
        f"and from errors at {len(ec.LOWDIM_PACK_CASES)}, equal their plain "
        f"versions")

    nchecked = 0
    for eb in (8, 16):
        half = 1 << (eb - 1)
        for nb in (1, FIRE_TILE_BLOCKS - 1, FIRE_TILE_BLOCKS + 1,
                   ring_blocks // 3, ring_blocks + 1):
            for nd in range(1, LOWDIM_MAX_NDIMS[eb // 8] + 1):
                vals = walk_stream(lrng, nb * 8, nd, eb // 8).astype(np.int32)
                if nb == ring_blocks // 3:
                    vals = lrng.integers(0, 2 * half, vals.shape
                                         ).astype(np.int32)
                state = torch.from_numpy(np.stack([
                    lrng.integers(0, 2 * half, nd),
                    lrng.integers(-half, half, nd),
                    lrng.integers(-(1 << 15), 1 << 15, nd)]).astype(np.int32))
                check_fire(f"FIRE full u{eb} nb {nb} D {nd}", vals, eb, state,
                           trunc=False)
                nchecked += 1
    # the counter wraps from a state 20 blocks' climb below its top; at u16
    # the full coefficient is then about 2^30 and prev_delta * coef wraps
    for eb in (8, 16):
        nb, nd = 300, 3
        steps = (np.tile([1, 127], nb * 4) if eb == 8
                 else np.full(nb * 8, 8000))
        vals = (np.cumsum(steps) % (1 << eb)).astype(np.int32)[:, None
                                                               ].repeat(nd, 1)
        state = np.zeros((3, nd), np.int32)
        top = (1 << 15) - 1 if eb == 8 else (1 << 31) - 1
        state[2] = top - 20 * (1 if eb == 8 else 8000)
        state = torch.from_numpy(state)
        errs = fc._fire_scan_plain(
            torch.from_numpy(vals).to(dev).long().reshape(nb, 8, nd), eb,
            False, state, truncate_coeffs=False).reshape(nb * 8, nd).to(
                torch.int32)
        out = check_fire(f"FIRE full u{eb} counter wrap", vals, eb, state,
                         errs, trunc=False)
        if not np.array_equal(dk.widen(out).cpu().numpy(), vals):
            raise AssertionError(f"FIRE full u{eb} counter wrap: decode from "
                                 f"the carried state differs from the stream")
    log(f"[kernels] FIRE with the full-precision coefficient equals its plain "
        f"version at {nchecked} ring shapes (D 1-4 u8, 1-2 u16) and across "
        f"the counter's wrap")

    def lowdim_inputs(x: np.ndarray, elem_sz: int):
        """Device inputs of the lowdim kernels from stream x, as the path
        makes them: the encode's narrow rows, FIRE's errors of the rows
        (the full-coefficient kernel's), and the decode's (dense, widths)
        from the stream's delta bytes."""
        eb, nd = 8 * elem_sz, x.shape[1]
        nrows = encoder.upload_rows(x, dev, narrow=True)
        rows = encoder.upload_rows(x, dev)
        buf = encoder.compress(x.reshape(-1), nd, device=dev)
        idx = decoder.walk_headers(buf, read_metadata_rle(buf)[0], nd,
                                   elem_sz, lowdim=True)
        dense, dwidths, _ = decoder.upload_payload(
            decoder.gather_payloads(buf, idx), idx, dev)
        return dict(nrows=nrows, dense=dense, dwidths=dwidths, eb=eb,
                    es=elem_sz, rows=rows,
                    ferrs=fc.fire_encode(rows, eb, truncate_coeffs=False))

    def check_lowdim(what, a):
        eb, es = a["eb"], a["es"]
        check("encode_lowdim", pk.encode_lowdim(a["nrows"], es),
              pk.encode_lowdim_plain(a["nrows"], es), what)
        check("encode_lowdim_errs", pk.encode_lowdim(a["ferrs"], es, True),
              pk.encode_lowdim_plain(a["ferrs"], es, True), what)
        check("unpack_lowdim_raw", dk.unpack_dims_lowdim(a["dense"],
                                                         a["dwidths"]),
              dk.unpack_dims_lowdim_plain(a["dense"], a["dwidths"]), what)
        vals = dk.decode_delta_lowdim(a["dense"], a["dwidths"], eb)
        check("decode_lowdim", vals,
              dk.decode_delta_lowdim_plain(a["dense"], a["dwidths"], eb), what)
        return vals

    ld_shapes = {
        "u8 d4 walk 4 MiB (nb 131072, D 4)": walk_stream(lrng, LOWDIM_ROWS, 4, 1),
        "u16 d2 walk 4 MiB (nb 131072, D 2)": walk_stream(lrng, LOWDIM_ROWS, 2, 2),
    }
    ld_inputs = {}
    for what, x in ld_shapes.items():
        a = ld_inputs[what] = lowdim_inputs(x, x.dtype.itemsize)
        vals = check_lowdim(what, a)
        if not np.array_equal(decoder.download_values(vals),
                              x[: vals.shape[0]].reshape(-1)):
            raise AssertionError(f"lowdim decode {what}: values differ "
                                 f"from the input")
        log(f"[kernels] {what}: encode_lowdim (from the rows and from "
            f"FIRE's errors), decode_lowdim and unpack_lowdim_raw equal "
            f"their plain versions; the decode gives the stream")
    # FIRE over one 32k-row stream a width: its plain version loops over
    # blocks in Python, so it runs once, and that run is its plain_ms
    ld_fire = {}
    for what, (nd, es) in (("u8 d4 walk 32k rows (nb 4096, D 4)", (4, 1)),
                           ("u16 d2 walk 32k rows (nb 4096, D 2)", (2, 2))):
        eb = 8 * es
        r = encoder.upload_rows(walk_stream(lrng, FIRE_PLAIN_ROWS, nd, es), dev)
        want_e, ms_e = once_ms(
            lambda: fc.fire_encode_plain(r, eb, truncate_coeffs=False))
        fe = fc.fire_encode(r, eb, truncate_coeffs=False)
        check("fire_encode_full", fe, want_e, what)
        fe = fe.to(torch.uint8) if eb == 8 else fe
        want_d, ms_d = once_ms(
            lambda: fc.fire_decode_plain(fe, eb, truncate_coeffs=False))
        check("fire_decode_full", fc.fire_decode(fe, eb, truncate_coeffs=False),
              want_d, what)
        if not torch.equal(dk.widen(want_d), r):
            raise AssertionError(f"FIRE full {what}: decode differs from the "
                                 f"stream")
        ld_fire[what] = dict(rows=r, ferrs=fe, eb=eb, plain_ms={
            "fire_encode_full": ms_e, "fire_decode_full": ms_d})
        log(f"[kernels] FIRE full {what}: kernels equal their plain versions "
            f"(plain encode {ms_e:.1f} ms, decode {ms_d:.1f} ms)")

    # ---------------------------------------------- 2c. seekable kernels
    # The sidecar path's kernels against their plain versions: FIRE's encode
    # with its states over the 8 MiB walks and the 32k-row lowdim streams;
    # over the 8 MiB and 4 MiB walks, at the chunks and states of each
    # stream's own sidecar (where they must give the stream) and from a
    # sidecar with one state changed, the chunked FIRE decode (both
    # coefficients: the sidecar's chunks of 16 groups on the short-chunk
    # kernel, every 64th checkpoint's chunks of 1024 groups on the ring
    # kernel) and the chunked delta decode (K1 then K2 with chunks, or the
    # lowdim decode; its plain version's also the serial decode followed
    # by delta_chunk_seed_plain); the same at the CPU tests' cuts
    # (host_build.FIRE_CASES and SHORT_CASES, unpack_cases.SEED_CASES and
    # CHUNK_CASES: ragged and empty chunks, starts mid-tile and at tile and
    # span edges, from random states); then the chunked FIRE decode and the
    # states' encode at the ring shapes with 1, 2, 7 and 33 chunks of
    # unequal lengths from random states. A generator of its own.
    krng = np.random.default_rng(SEED + 7)

    def sidecar_cuts(x: np.ndarray, codec: str, nblocks: int):
        """The chunks of x's own sidecar as C + 1 first blocks, the last
        nblocks, and its states."""
        _, sc = checkpoint.compress_with_sidecar(
            x.reshape(-1), x.shape[1], codec=codec, device=dev)
        return (np.append(sc.row_offsets // 8, nblocks).astype(np.int64),
                torch.from_numpy(sc.states))

    def moved(states: torch.Tensor) -> torch.Tensor:
        """states with the middle chunk's replaced by random values."""
        out = states.clone()
        k = out.shape[0] // 2
        out[k] = torch.from_numpy(krng.integers(
            -(1 << 15), 1 << 15, tuple(out[k].shape)).astype(np.int32))
        return out

    def fire_chunk_kernel(first, nd: int, eb: int, trunc: bool) -> str:
        """The kernel that fire_decode_chunks launches at chunks `first`."""
        short = fc.fire_short_fits(int(np.diff(first).max()), nd, eb)
        return (("fire_decode_short" if short else "fire_decode_chunks")
                + ("" if trunc else "_full"))

    def check_fire_chunks(zz, eb, first, states, trunc, what):
        got = fc.fire_decode_chunks(zz, eb, first, states, trunc)
        check(fire_chunk_kernel(first, zz.shape[1], eb, trunc), got,
              fc.fire_decode_chunks_plain(zz, eb, first, states, trunc), what)
        return got

    def check_delta_chunks(dense, dwidths, eb, ck, lowdim, what, serial=None):
        """The chunked delta decode of a payload (K1 then K2, or the lowdim
        decode) against its plain version and, given the serial decode's
        values, against them followed by the plain chunk seed."""
        if lowdim:
            name = "decode_lowdim_chunks"
            got = dk.decode_delta_lowdim(dense, dwidths, eb, ck)
            check(name, got, dk.decode_delta_lowdim_plain(dense, dwidths, eb,
                                                          ck), what)
        else:
            name = "prefix_finish_chunks"
            bz, toff = dk.unpack_zz(dense, dwidths, eb, ck)
            check("unpack_zz_chunks", (bz, toff),
                  dk.unpack_zz_plain(dense, dwidths, eb, ck), what)
            bz = bz.reshape(-1, bz.shape[2])
            got = dk.prefix_finish(bz, toff, eb, ck)
            check(name, got, dk.prefix_finish_plain(bz, toff, eb, ck), what)
        if serial is not None:
            check(name, got, dk.delta_chunk_seed_plain(
                serial, ck.first * 8, ck.states, eb), what + ", against the "
                "serial decode and the seed")
        return got

    seek = {}
    for what, a, x in (
            [(w, inputs[w], shapes[w]) for w in list(shapes)[:2]]
            + [(w, ld_inputs[w], ld_shapes[w]) for w in ld_shapes]):
        eb, nd = a["eb"], x.shape[1]
        trunc = nd > LOWDIM_MAX_NDIMS[eb // 8]
        sfx = "" if trunc else "_full"
        r, nblocks = a["rows"], a["rows"].shape[0] // 8
        fe = a["ferrs"] if trunc else (a["ferrs"].to(torch.uint8) if eb == 8
                                       else a["ferrs"])
        if trunc:  # the plain encode is a loop over blocks: 8 MiB at most
            got = fc.fire_encode(r, eb, states=True)
            (want_e, want_c), ms_s = once_ms(
                lambda: fc.fire_encode_plain(r, eb, states=True))
            check("fire_encode_states", got, (want_e, want_c), what)
            a["fire_plain_ms"]["fire_encode_states"] = ms_s
        first, states = sidecar_cuts(x, "xff", nblocks)
        # every 64th checkpoint: chunks of 1024 groups, past the short
        # kernel's budget
        lfirst, lstates = np.append(first[:-1][::64], nblocks), states[::64]
        for f, st, how in ((first, states, ""),
                           (first, moved(states), ", a changed state"),
                           (lfirst, lstates, ", chunks of 1024 groups")):
            got = check_fire_chunks(fe, eb, f, st, trunc, what + how)
            if how != ", a changed state" and not torch.equal(dk.widen(got), r):
                raise AssertionError(f"fire_decode_chunks {what}{how}: values "
                                     f"from the stream's own sidecar differ")
        kinds = (fire_chunk_kernel(first, nd, eb, trunc),
                 fire_chunk_kernel(lfirst, nd, eb, trunc))
        if kinds != ("fire_decode_short" + sfx, "fire_decode_chunks" + sfx):
            raise AssertionError(f"{what}: the chunked FIRE decode took "
                                 f"{kinds} at 16 and 1024 groups a chunk")
        serial = (dk.decode_delta_contiguous(a["dense"], a["dwidths"], eb)
                  if trunc else dk.decode_delta_lowdim(a["dense"],
                                                       a["dwidths"], eb))
        dfirst, dstates = sidecar_cuts(x, "delta", serial.shape[0] // 8)
        dst = dstates[:, 0]
        for st, how in ((dst, ""), (moved(dst[:, None])[:, 0],
                                    ", a changed state")):
            ck = dk.delta_chunks(dfirst, st, int(dfirst[-1]), nd, dev)
            got = check_delta_chunks(a["dense"], a["dwidths"], eb, ck,
                                     not trunc, what + how, serial)
            if not how and not torch.equal(got, serial):
                raise AssertionError(f"chunked delta decode {what}: values "
                                     f"from the stream's own sidecar differ")
        seek[what] = dict(a=a, fe=fe, first=first, states=states,
                          lfirst=lfirst, lstates=lstates, trunc=trunc,
                          serial=serial, dfirst=dfirst, dst=dst, eb=eb,
                          lowdim=not trunc)
        log(f"[kernels] {what}: the chunked FIRE decode at its sidecar's "
            f"{first.size - 1} chunks (short-chunk kernel; and a changed "
            f"state) and at {lfirst.size - 1} chunks of 1024 groups (ring "
            f"kernel), the chunked delta decode at {dfirst.size - 1} chunks "
            f"(and a changed state) equal their plain versions"
            + ("; fire_encode_states too" if trunc else ""))
    for what, f in ld_fire.items():  # the full coefficient's states, 32k rows
        eb, r = f["eb"], f["rows"]
        got = fc.fire_encode(r, eb, truncate_coeffs=False, states=True)
        want, ms_s = once_ms(lambda: fc.fire_encode_plain(
            r, eb, truncate_coeffs=False, states=True))
        check("fire_encode_states_full", got, want, what)
        f["plain_ms"]["fire_encode_states_full"] = ms_s
    # the CPU tests' cuts: FIRE's (random states) and the delta decode's
    # (states that continue the stream, and moved ones)
    for eb, nd, nb, chunks, trunc in (
            [(e, d, b, c, t) for e, d, b, c, t in FIRE_CASES] + SHORT_CASES):
        zz, first, states = short_case(eb, nd, nb, chunks, trunc)
        check_fire_chunks(zz.to(dev), eb, first, states.to(dev), trunc,
                          f"cut u{eb} D {nd} nb {nb} chunks {chunks}")
    delta_cuts = [(eb, nd, nb, chunk_cuts(np.random.default_rng(eb + nd + nb), nb,
                                          c)) for eb, nd, nb, c in uc.SEED_CASES]
    delta_cuts += [(eb, nd, nb, np.asarray(f)) for _, eb, nd, nb, f in
                   uc.CHUNK_CASES]
    for eb, nd, nb, first in delta_cuts:
        crng = np.random.default_rng(eb * 3 + nd + nb)
        layouts = [(uc.unpack_case(crng, eb, nd, nb, "random"), False)]
        if nd * eb <= 32:
            layouts.append((uc.lowdim_case(crng, eb, nd, nb, "random"), True))
        for (dense, widths, _), lowdim in layouts:
            d, w = uc.to_device(dense, widths, "random", dev)
            serial = (dk.decode_delta_lowdim(d, w, eb) if lowdim
                      else dk.decode_delta_contiguous(d, w, eb))
            sv = dk.widen(serial).cpu().numpy()
            for mv in (False, True):
                st = chunk_states(crng, sv, first, eb, mv)
                ck = dk.delta_chunks(first, st, nb, nd, dev)
                check_delta_chunks(d, w, eb, ck, lowdim,
                                   f"cut u{eb} D {nd} nb {nb}, {first.size - 1} "
                                   f"chunks" + (", moved" if mv else ""),
                                   serial)
    log(f"[kernels] the chunked FIRE decode at {len(FIRE_CASES) + len(SHORT_CASES)}"
        f" and the chunked delta decode at {len(delta_cuts)} of the CPU tests' "
        f"cuts equal their plain versions")
    nchecked = 0
    for eb in (8, 16):
        for nb in (1, FIRE_TILE_BLOCKS - 1, FIRE_TILE_BLOCKS + 1,
                   ring_blocks // 3, ring_blocks + 1):
            for nd in (1, 31, 33, 129) + tuple(
                    range(2, LOWDIM_MAX_NDIMS[eb // 8] + 1)):
                trunc = nd > LOWDIM_MAX_NDIMS[eb // 8]
                sfx = "" if trunc else "_full"
                vals = torch.from_numpy(walk_stream(
                    krng, nb * 8, nd, eb // 8).astype(np.int32)).to(dev)
                got = fc.fire_encode(vals, eb, trunc, states=True)
                check("fire_encode_states" + sfx, got,
                      fc.fire_encode_plain(vals, eb, trunc, states=True),
                      f"ring shape u{eb} nb {nb} D {nd}")
                zz = got[0].to(torch.uint8) if eb == 8 else got[0]
                nchunks = (1, 2, 7, 33)[nchecked % 4]
                first = chunk_cuts(krng, nb, nchunks)
                half = 1 << (eb - 1)
                states = torch.from_numpy(np.stack([
                    krng.integers(0, 2 * half, (nchunks, nd)),
                    krng.integers(-half, half, (nchunks, nd)),
                    krng.integers(-(1 << 15), 1 << 15, (nchunks, nd))],
                    axis=1).astype(np.int32))
                check_fire_chunks(zz, eb, first, states, trunc,
                                  f"ring shape u{eb} nb {nb} D {nd}, "
                                  f"{nchunks} chunks")
                nchecked += 1
    log(f"[kernels] fire_encode_states and the chunked FIRE decode (both "
        f"coefficients, both kernels) equal their plain versions at "
        f"{nchecked} ring shapes (1, 2, 7 and 33 chunks of unequal lengths, "
        f"random states)")

    # ------------------------------------------------------ 3. main path
    streams = {
        "u8 walk 8 MiB": walk_stream(rng, 1 << 17, 64, 1),
        "u16 walk 8 MiB": walk_stream(rng, 1 << 16, 64, 2),
        "u8 runs 8 MiB": runs_stream(rng, 1 << 17, 64),
        "u8 smooth 8 MiB": smooth_stream(rng, 1 << 17, 64),
        "u8 walk 64 MiB": walk_stream(rng, 1 << 20, 64, 1),
    }
    # (stream, codec, entropy) of the main path's run
    cases = [(w, "delta", "none") for w in (
        "u8 walk 8 MiB", "u16 walk 8 MiB", "u8 runs 8 MiB", "u8 walk 64 MiB")]
    cases += [(w, "xff", "none") for w in (
        "u8 walk 8 MiB", "u16 walk 8 MiB", "u8 runs 8 MiB")]
    cases += [(w, c, "huffman") for c in ("delta", "xff") for w in (
        "u8 walk 8 MiB", "u8 smooth 8 MiB", "u8 walk 64 MiB")]

    def codec_of(case):
        what, codec, entropy = case
        return SprintzCodec(codec, streams[what].dtype.itemsize,
                            entropy=entropy, device="cuda")

    bufs = {}
    zero_counts()
    for case in cases:
        x = streams[case[0]]
        buf = codec_of(case).compress(x)
        if not np.array_equal(codec_of(case).decompress(buf), x.reshape(-1)):
            raise AssertionError(f"main path {case}: round trip differs")
        bufs[case] = buf
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    host_calls("main", HOST_ROWMAJOR_PATH)
    for case in cases:
        x, buf = streams[case[0]], bufs[case]
        log(f"[main] {' '.join(case)}: {x.nbytes} B -> {len(buf)} B (ratio "
            f"{x.nbytes / len(buf):.4f}), round trip exact"
            + (f", Huffman container {hf.is_container(buf)}"
               if case[2] == "huffman" else ""))
    for c in ("delta", "xff"):
        if not hf.is_container(bufs[("u8 smooth 8 MiB", c, "huffman")]):
            raise AssertionError(f"{c}+Huf on the smooth stream: Huffman "
                                 f"did not win, so K6 never ran on it")
    log(f"[main] launches: {json.dumps(launches)}")
    missing = [k for k in ROWMAJOR_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")

    # K6 and the encoder on each +Huf case's own sprintz stream, at the
    # chunk size the path coded it with (4096 under 4 MiB, else 128)
    for what, codec, entropy in cases:
        if entropy != "huffman":
            continue
        x = streams[what]
        inner = np.frombuffer(SprintzCodec(codec, x.dtype.itemsize,
                                           device="cuda").compress(x),
                              np.uint8)
        cs = hf.auto_chunk_symbols(inner.size)
        key = (f"main path {what} {codec} sprintz stream ({inner.size} B, "
               f"cs {cs})")
        h = check_huff(key, inner, cs)
        if (what, codec) == ("u8 smooth 8 MiB", "delta"):
            huff_smooth = (key, h)

    x1 = walk_stream(rng, 1 << 14, 64, 1)  # 1 MiB
    for codec, entropy in (("delta", "none"), ("xff", "none"),
                           ("xff", "huffman")):
        gpu = SprintzCodec(codec, 1, entropy=entropy, device="cuda")
        cpu = SprintzCodec(codec, 1, entropy=entropy, device="cpu")
        b_gpu = gpu.compress(x1)
        b_cpu = cpu.compress(x1)
        if b_gpu != b_cpu:
            raise AssertionError(f"1 MiB stream, {codec}+{entropy}: card "
                                 f"bytes differ from CPU bytes")
        if not np.array_equal(gpu.decompress(b_cpu), cpu.decompress(b_gpu)):
            raise AssertionError(f"1 MiB stream, {codec}+{entropy}: card and "
                                 f"CPU decode differ")
        log(f"[main] 1 MiB stream, {codec}+{entropy}: card bytes == CPU "
            f"bytes")

    # a +Huf stream whose container has a chunk overrun: the card raises
    x = smooth_stream(np.random.default_rng(SEED + 3), 1 << 10, 64)
    buf = SprintzCodec("delta", 1, entropy="huffman", device="cuda").compress(x)
    if not hf.is_container(buf):
        raise AssertionError("corrupt-container phase: Huffman did not win")
    bad = dc.overrun(buf, hf._parse(buf)[2] // 2)
    try:
        SprintzCodec("delta", 1, entropy="huffman",
                     device="cuda").decompress(bad)
    except CorruptStreamError as e:
        log(f"[main] an overrun +Huf container raises on the card: {e}")
    else:
        raise AssertionError("an overrun +Huf container decoded on the card "
                             "without raising")

    vec = here / "tests" / "vectors"
    for name, codec, nd, es in (("delta_8b_d9_rand", "delta", 9, 1),
                                ("delta_16b_d17_sparse", "delta", 17, 2),
                                ("xff_8b_d16_sparse", "xff", 16, 1),
                                ("xff_16b_d8_rand", "xff", 8, 2),
                                ("delta_8b_d1_sparse", "delta", 1, 1),
                                ("delta_16b_d2_small", "delta", 2, 2),
                                ("xff_8b_d3_walk", "xff", 3, 1),
                                ("xff_16b_d1_walk", "xff", 1, 2)):
        ref = (vec / f"{name}.sprintz").read_bytes()
        want = np.frombuffer((vec / f"{name}.in").read_bytes(),
                             dtype=np.uint8 if es == 1 else np.uint16)
        if not np.array_equal(sprintz_tpu_torch.decompress(
                ref, codec=codec, elem_sz=es, device="cuda"), want):
            raise AssertionError(f"vector {name}: decode differs")
        if encoder.compress(want, nd, codec=codec, device="cuda") != ref:
            raise AssertionError(f"vector {name}: re-encode differs")
    log("[main] reference vectors (row-major and lowdim) decode and "
        "re-encode exactly")

    class KernelClock:
        """Card time inside the kernel launches: CUDA events recorded on
        the launch's stream just before and after each C entry point is
        called. Where the card waits for the host's launch, the wait
        counts, so this is an upper bound on the kernels' own time."""

        def __enter__(self):
            self.events, self.launch = [], _build.launch

            def timed(name, like, *args):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                self.launch(name, like, *args)
                e.record()
                self.events.append((s, e))

            _build.launch = timed
            return self

        def __exit__(self, *exc):
            _build.launch = self.launch

        def seconds(self) -> float:
            torch.cuda.synchronize()
            return sum(s.elapsed_time(e) for s, e in self.events) / 1e3

    # ------------------------------------------------ 3b. lowdim main path
    # bench.py's extra_lowdim stream (1M rows x 4 dims of a u8 walk,
    # bench.py:451-479) and its u16 twin (1M x 2), a d4 runs stream and a
    # d4 smooth stream for +Huf, then smaller widths at 256k rows; every
    # kernel's count set to 0 just before and read just after.
    srng = np.random.default_rng(SEED + 6)
    streams.update({
        "u8 d4 walk 4 MiB": walk_stream(srng, LOWDIM_ROWS, 4, 1),
        "u16 d2 walk 4 MiB": walk_stream(srng, LOWDIM_ROWS, 2, 2),
        "u8 d4 runs 4 MiB": runs_stream(srng, LOWDIM_ROWS, 4),
        "u8 d4 smooth 4 MiB": smooth_stream(srng, LOWDIM_ROWS, 4),
        "u8 d1 walk 256 KiB": walk_stream(srng, LOWDIM_SMALL_ROWS, 1, 1),
        "u8 d2 walk 512 KiB": walk_stream(srng, LOWDIM_SMALL_ROWS, 2, 1),
        "u8 d3 walk 768 KiB": walk_stream(srng, LOWDIM_SMALL_ROWS, 3, 1),
        "u16 d1 walk 512 KiB": walk_stream(srng, LOWDIM_SMALL_ROWS, 1, 2),
    })
    ld_cases = [(w, c, "none") for c in ("delta", "xff") for w in (
        "u8 d4 walk 4 MiB", "u16 d2 walk 4 MiB", "u8 d1 walk 256 KiB",
        "u8 d2 walk 512 KiB", "u8 d3 walk 768 KiB", "u16 d1 walk 512 KiB")]
    ld_cases += [("u8 d4 runs 4 MiB", "delta", "none"),
                 ("u8 d4 smooth 4 MiB", "delta", "huffman")]
    zero_counts()
    for case in ld_cases:
        x = streams[case[0]]
        buf = codec_of(case).compress(x)
        if not np.array_equal(codec_of(case).decompress(buf), x.reshape(-1)):
            raise AssertionError(f"lowdim path {case}: round trip differs")
        bufs[case] = buf
    ld_launches = {k: getattr(obj, attr) for k, (obj, attr) in
                   counters.items()}
    host_calls("lowdim", HOST_LOWDIM_PATH)
    for case in ld_cases:
        x, buf = streams[case[0]], bufs[case]
        log(f"[lowdim] {' '.join(case)}: {x.nbytes} B -> {len(buf)} B (ratio "
            f"{x.nbytes / len(buf):.4f}), round trip exact"
            + (f", Huffman container {hf.is_container(buf)}"
               if case[2] == "huffman" else ""))
    if not hf.is_container(bufs[("u8 d4 smooth 4 MiB", "delta", "huffman")]):
        raise AssertionError("lowdim delta+Huf on the smooth stream: Huffman "
                             "did not win, so K6 never ran on it")
    log(f"[lowdim] launches: {json.dumps(ld_launches)}")
    missing = [k for k in LOWDIM_PATH if ld_launches[k] == 0]
    if missing:
        raise AssertionError(f"lowdim path never launched: {missing}")
    stray = [k for k in ROWMAJOR_PATH - LOWDIM_PATH if ld_launches[k]]
    if stray:
        raise AssertionError(f"lowdim path launched row-major kernels: {stray}")
    # a lowdim delta encode's and decode's device pass: one kernel each
    x = streams["u8 d4 walk 4 MiB"]
    buf = bufs[("u8 d4 walk 4 MiB", "delta", "none")]
    idx = decoder.walk_headers(buf, read_metadata_rle(buf)[0], 4, 1, True)
    up = decoder.upload_payload(decoder.gather_payloads(buf, idx), idx, dev)
    rows = encoder.upload_rows(x, dev, narrow=True)
    for side, fn in (("encode", lambda: encoder.encode_device(rows, 1, "delta",
                                                              True)),
                     ("decode", lambda: decoder.decode_device(
                         *up, idx.total_rows, 1, "delta", True))):
        with KernelClock() as clock:
            fn()
        if len(clock.events) != 1:
            raise AssertionError(f"lowdim delta {side}: {len(clock.events)} "
                                 f"kernel launches in its device pass, not 1")
    log("[lowdim] K1 and K2 never launched; a delta encode's and decode's "
        "device pass launch one kernel each")
    # a kernel's launches on the main paths: both paths' counts
    launches = {k: launches[k] + ld_launches[k] for k in KERNELS}
    # K6 and the encoder on the lowdim +Huf case's own sprintz stream
    x = streams["u8 d4 smooth 4 MiB"]
    inner = np.frombuffer(SprintzCodec("delta", 1, device="cuda").compress(x),
                          np.uint8)
    check_huff(f"lowdim path u8 d4 smooth 4 MiB delta sprintz stream "
               f"({inner.size} B, cs {hf.auto_chunk_symbols(inner.size)})",
               inner, hf.auto_chunk_symbols(inner.size))
    # card bytes == CPU bytes: delta on whole streams, xff on their first
    # 32k rows (the plain FIRE, a Python loop over blocks, is affordable
    # there; a fault that encode and decode share would still round-trip)
    for what, codec, entropy in ld_cases:
        x = streams[what]
        if codec == "xff":
            x = x[:FIRE_PLAIN_ROWS]
            b_gpu = codec_of((what, codec, entropy)).compress(x)
        else:
            b_gpu = bufs[(what, codec, entropy)]
        b_cpu = SprintzCodec(codec, x.dtype.itemsize, entropy=entropy,
                             device="cpu").compress(x)
        if b_gpu != b_cpu:
            raise AssertionError(f"lowdim {what} {codec}+{entropy}: card bytes "
                                 f"differ from CPU bytes")
    log("[lowdim] card bytes == CPU bytes on every lowdim stream (xff on its "
        f"first {FIRE_PLAIN_ROWS} rows)")

    # ---------------------------------------------------------- 3c. host
    # The host library against its plain Python versions on every stream
    # of both paths, for each codec the paths ran it with: the device pass
    # on the card gives the plan's and the assembly's inputs; the assembled
    # bytes must be the path's stream, which the walk and the gather then
    # index. Host clock; the library's time a median of HOST_REPS calls,
    # the Python version's one call.
    def host_ms(fn, reps=HOST_REPS):
        times, out = [], None
        for _ in range(reps):
            c = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - c)
        return out, statistics.median(times) * 1e3

    def same(a, b, what):
        if not (a.shape == b.shape and a.dtype == b.dtype
                and np.array_equal(a, b)):
            raise AssertionError(f"host {what}: the library differs from "
                                 f"the Python version")

    host = {}
    for what, codec in dict.fromkeys((w, c) for w, c, _ in cases + ld_cases):
        x = streams[what]
        es, nd, flat = x.dtype.itemsize, x.shape[1], x.reshape(-1)
        lowdim = nd <= LOWDIM_MAX_NDIMS[es]
        key = f"{what} {codec}"
        stream = bufs.get((what, codec, "none")) or SprintzCodec(
            codec, es, device="cuda").compress(x)
        nb = flat.size // (8 * nd)
        w, h, d, ws = encoder.encode_device(encoder.upload_rows(
            flat[:nb * 8 * nd].reshape(-1, nd), dev,
            narrow=lowdim and codec == "delta"), es, codec, lowdim)
        w, h, d, ws = (w.to(torch.uint8).cpu().numpy(),
                       h.to(torch.uint8).cpu().numpy(), d.cpu().numpy(),
                       ws.cpu().numpy())
        eq = codec == "xff" and not lowdim
        t = {}
        plan, t["plan"] = host_ms(lambda: build_plan(ws == 0, flat.size, nd,
                                                     eq))
        plan_py, t["plan py"] = host_ms(lambda: planner._build_plan_py(
            ws == 0, flat.size, nd, eq), 1)
        for f in ("kinds", "values"):
            same(getattr(plan, f), getattr(plan_py, f), f"{key} plan {f}")
        if (plan.ngroups, plan.consumed_blocks, plan.remaining_elems) != (
                plan_py.ngroups, plan_py.consumed_blocks,
                plan_py.remaining_elems):
            raise AssertionError(f"host {key} plan: counts differ")
        tail = flat[flat.size - plan.remaining_elems:]
        out, t["assemble"] = host_ms(lambda: encoder.assemble_stream(
            plan, w, h, d, nd, es, tail, lowdim, ws))
        out_py, t["assemble py"] = host_ms(lambda: encoder._assemble_stream_py(
            plan, w, h, d, nd, es, tail, lowdim), 1)
        if not out == out_py == stream:
            raise AssertionError(f"host {key} assembly: bytes differ")
        ng, _, _ = read_metadata_rle(stream)
        idx, t["walk"] = host_ms(lambda: decoder.walk_headers(
            stream, ng, nd, es, lowdim))
        idx_py, t["walk py"] = host_ms(lambda: decoder._walk_headers_py(
            stream, ng, nd, es, lowdim), 1)
        for f in ("widths", "payload_offsets", "out_rows", "row_bytes"):
            same(getattr(idx, f), getattr(idx_py, f), f"{key} walk {f}")
        if (idx.total_rows, idx.tail_offset, idx.section_bytes) != (
                idx_py.total_rows, idx_py.tail_offset, idx_py.section_bytes):
            raise AssertionError(f"host {key} walk: rows or tail differ")
        dense, t["gather"] = host_ms(lambda: decoder.gather_payloads(
            stream, idx))
        dense_py, t["gather py"] = host_ms(
            lambda: decoder._gather_payloads_py(stream, idx_py), 1)
        same(dense, dense_py, f"{key} gather")
        sym = np.frombuffer(stream, np.uint8)
        counts, t["histogram"] = host_ms(lambda: native_host.histogram(sym))
        counts_py, t["histogram py"] = host_ms(
            lambda: np.bincount(sym, minlength=256), 1)
        same(counts, counts_py, f"{key} histogram")
        host[key] = t
        log(f"[host] {key} ({len(stream)} B): library == Python; ms library"
            " / Python: " + ", ".join(
                f"{k} {t[k]:.3f} / {t[k + ' py']:.3f}" for k in
                ("walk", "gather", "plan", "assemble", "histogram")))
    log("[host] " + json.dumps({"card": smi, "streams": host}))

    # ------------------------------------------------------ 3d. seekable
    # The sidecar path: compress_seekable, then decompress(sidecar=) and
    # decode_range at three ranges, on the 8 MiB u8 and u16 walks, the u8
    # runs stream and the 4 MiB u8 d4 and u16 d2 walks with delta and xff,
    # on the u8 smooth stream with delta+Huf and xff+Huf, and on the 64
    # MiB u8 walk with xff (whose walk runs on threads); every count
    # set to 0 just before and read just after. Every sidecar kernel must
    # launch (decode_range(0, 64) decodes one chunk from row 0 to the
    # stream's end: FIRE's ring kernel there, its short-chunk kernel at the
    # sidecars' chunks), FIRE's serial kernels never, and the host
    # library's parallel walk must run. The stream bytes must be
    # compress's.
    sk_cases = [(w, c, "none") for c in ("delta", "xff") for w in (
        "u8 walk 8 MiB", "u16 walk 8 MiB", "u8 runs 8 MiB",
        "u8 d4 walk 4 MiB", "u16 d2 walk 4 MiB")]
    sk_cases += [("u8 smooth 8 MiB", c, "huffman") for c in ("delta", "xff")]
    sk_cases += [("u8 walk 64 MiB", "xff", "none")]  # a walk on threads
    sidecars, sk_bufs = {}, {}
    zero_counts()
    for case in sk_cases:
        x = streams[case[0]]
        cd = codec_of(case)
        buf, sc = cd.compress_seekable(x)
        if not np.array_equal(cd.decompress(buf, sidecar=sc), x.reshape(-1)):
            raise AssertionError(f"seekable {case}: round trip differs")
        plain = (hf.huff_decompress(buf, device=dev).tobytes()
                 if hf.is_container(buf) else buf)
        n = x.shape[0]
        for start, nrows in ((0, 64), (n // 3 + 5, 1000), (n - 700, 700)):
            got = checkpoint.decode_range(plain, sc, start, nrows, device=dev)
            if not np.array_equal(got, x[start: start + nrows]):
                raise AssertionError(f"seekable {case}: decode_range({start}, "
                                     f"{nrows}) differs")
        sidecars[case], sk_bufs[case] = sc, buf
    sk_launches = {k: getattr(obj, attr) for k, (obj, attr) in
                   counters.items()}
    host_calls("seekable", HOST_SEEKABLE_PATH)
    log(f"[seekable] launches: {json.dumps(sk_launches)}")
    missing = [k for k in SEEKABLE_PATH if sk_launches[k] == 0]
    if missing:
        raise AssertionError(f"seekable path never launched: {missing}")
    serial = [k for k in ("fire_encode", "fire_decode", "fire_encode_full",
                          "fire_decode_full") if sk_launches[k]]
    if serial:
        raise AssertionError(f"seekable path ran FIRE's serial kernels: "
                             f"{serial}")
    for case in sk_cases:
        x, buf, sc = streams[case[0]], sk_bufs[case], sidecars[case]
        want = bufs.get(case) or codec_of(case).compress(x)
        if buf != want:
            raise AssertionError(f"seekable {case}: stream bytes differ from "
                                 f"compress's")
        side = len(sc.to_bytes())
        log(f"[seekable] {' '.join(case)}: {len(buf)} B stream, sidecar "
            f"{len(sc.byte_offsets)} checkpoints, {side} B ({side / len(buf):.4%}"
            f" of the stream); bytes == compress's, decompress(sidecar=) and "
            f"decode_range exact")
    if not all(hf.is_container(sk_bufs[c]) for c in sk_cases
               if c[2] == "huffman"):
        raise AssertionError("seekable +Huf on the smooth stream: Huffman did "
                             "not win, so K6 never ran on it")
    launches = {k: launches[k] + sk_launches[k] for k in KERNELS}

    # --------------------------------------------------------- 3e. batch
    # The batch API (SprintzCodec.compress_batch / decompress_batch) on
    # bench.py's xff-batch shape (512 streams x 256 rows x 64 dims of a u8
    # walk, bench.py:755-779), its u16 twin (512 x 128 x 64), a lowdim
    # batch (512 x 2048 x 4 u8) and 64 runs streams (2048 x 64), each with
    # delta and xff, and a mixed delta batch (a stream with a tail, a short
    # verbatim stream, a stream of another ndims); every count set to 0
    # just before and read just after. FIRE's encode must launch once a
    # batch, a batch's decode must be one decode_device, the lowdim encode
    # from the rows never (its delta would cross streams), FIRE's serial
    # decode never; every stream's bytes must be its own compress's on the
    # card and every decoded stream its input. A generator of its own.
    t_phase = time.perf_counter()
    brng = np.random.default_rng(SEED + 12)
    batches = {
        "u8 512 x 256 x 64": walk_stream(brng, 512 * 256, 64, 1).reshape(
            512, 256, 64),
        "u16 512 x 128 x 64": walk_stream(brng, 512 * 128, 64, 2).reshape(
            512, 128, 64),
        "u8 512 x 2048 x 4": walk_stream(brng, 512 * 2048, 4, 1).reshape(
            512, 2048, 4),
        "u8 runs 64 x 2048 x 64": runs_stream(brng, 64 * 2048, 64).reshape(
            64, 2048, 64),
    }
    mixed = [walk_stream(brng, 1000, 64, 1), walk_stream(brng, 1, 64, 1),
             walk_stream(brng, 800, 9, 1), walk_stream(brng, 2048, 64, 1)]
    b_cases = [(w, c) for w in batches for c in ("delta", "xff")]
    real_decode_device = decoder.decode_device
    decode_calls = []

    def counted_decode_device(*a, **k):
        decode_calls.append(1)
        return real_decode_device(*a, **k)

    def fire_encodes() -> int:
        return fc.fire_encode.launches + fc.fire_encode.full_launches

    b_bufs, b_fire, b_decodes = {}, {}, {}
    zero_counts()
    decoder.decode_device = counted_decode_device
    try:
        for case in b_cases:
            x = batches[case[0]]
            cd = SprintzCodec(case[1], x.dtype.itemsize, device="cuda")
            f0 = fire_encodes()
            b_bufs[case] = cd.compress_batch(list(x))
            b_fire[case] = fire_encodes() - f0
            n0 = len(decode_calls)
            out = cd.decompress_batch(b_bufs[case])
            b_decodes[case] = len(decode_calls) - n0
            if not all(np.array_equal(o, s.reshape(-1))
                       for o, s in zip(out, x)):
                raise AssertionError(f"batch {case}: a decoded stream differs "
                                     f"from its input")
        cd = SprintzCodec("delta", 1, device="cuda")
        mixed_bufs = cd.compress_batch(mixed)
        out = cd.decompress_batch(mixed_bufs)
        if not all(np.array_equal(o, s.reshape(-1))
                   for o, s in zip(out, mixed)):
            raise AssertionError("mixed batch: a decoded stream differs from "
                                 "its input")
    finally:
        decoder.decode_device = real_decode_device
    b_launches = {k: getattr(obj, attr) for k, (obj, attr) in
                  counters.items()}
    host_calls("batch", (HOST_ROWMAJOR_PATH | HOST_LOWDIM_PATH)
               - {"histogram"})
    log(f"[batch] launches: {json.dumps(b_launches)}")
    missing = [k for k in BATCH_PATH if b_launches[k] == 0]
    if missing:
        raise AssertionError(f"batch path never launched: {missing}")
    stray = [k for k in ("encode_lowdim", "fire_decode", "fire_decode_full")
             if b_launches[k]]
    if stray:
        raise AssertionError(f"batch path launched {stray}")
    for case in b_cases:
        want_fire = int(case[1] == "xff")
        if b_fire[case] != want_fire or b_decodes[case] != 1:
            raise AssertionError(
                f"batch {case}: {b_fire[case]} FIRE encode launches (not "
                f"{want_fire}), {b_decodes[case]} decode_device calls (not 1)")
    b_single = {}
    for case in b_cases:
        x = batches[case[0]]
        cd = SprintzCodec(case[1], x.dtype.itemsize, device="cuda")
        c = time.perf_counter()
        single = [cd.compress(s) for s in x]
        t_enc = time.perf_counter() - c
        c = time.perf_counter()
        for b in single:
            cd.decompress(b)
        b_single[case] = {"encode": t_enc,
                          "decode": time.perf_counter() - c}
        if single != b_bufs[case]:
            raise AssertionError(f"batch {case}: bytes differ from each "
                                 f"stream's own compress")
        log(f"[batch] {' '.join(case)}: {x.shape[0]} streams, {x.nbytes} B "
            f"-> {sum(map(len, single))} B; bytes == each stream's compress, "
            f"decode exact; {b_fire[case]} FIRE encode launch, one "
            f"decode_device")
    cd = SprintzCodec("delta", 1, device="cuda")
    if mixed_bufs != [cd.compress(s) for s in mixed]:
        raise AssertionError("mixed batch: bytes differ from compress's")
    log("[batch] mixed batch (a tail, a verbatim stream, another ndims): "
        f"bytes == compress's, decode exact; the phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    launches = {k: launches[k] + b_launches[k] for k in KERNELS}

    # --------------------------------------------------------- 3f. query
    # Query pushdown (sprintz_tpu_torch.query) on the 8 MiB u8 walk and the
    # 8 MiB runs stream (delta: the compact pass, the second with gaps), an
    # 8 MiB u16 stream near 65535 whose sums wrap past 2^31, the 4 MiB u8
    # d4 walk (the lowdim compact pass) and the 8 MiB u8 walk under xff (the
    # fused pass), every op with materialize True and False; every count
    # set to 0 just before and read just after (the NOOP queries, a decode,
    # in a count of their own). Results must equal numpy over the raw data,
    # sums wrapped to int32 on the device's share; then the epilogue
    # kernels and reduce_cols equal their plain versions on each stream.
    t_phase = time.perf_counter()
    qrng = np.random.default_rng(SEED + 13)
    streams["u16 top 8 MiB"] = (65535 - np.cumsum(qrng.integers(
        0, 4, (1 << 16, 64)), axis=0) % 512).astype(np.uint16)
    q_cases = [("u8 walk 8 MiB", "delta", "compact"),
               ("u8 runs 8 MiB", "delta", "compact"),
               ("u16 top 8 MiB", "delta", "compact"),
               ("u8 d4 walk 4 MiB", "delta", "compact"),
               ("u8 walk 8 MiB", "xff", "fused")]
    q_bufs = {c: bufs.get((c[0], c[1], "none")) or SprintzCodec(
        c[1], streams[c[0]].dtype.itemsize, device="cuda").compress(
        streams[c[0]]) for c in q_cases}
    ops = list(tquery.Operation)

    def expected(x: np.ndarray, buf: bytes, op):
        """numpy over the raw rows: the device's share of a sum wraps to
        int32, the verbatim tail's is added in int64."""
        rem = read_metadata_rle(buf)[1]
        flat = x.reshape(-1)
        body, tail = flat[: x.size - rem], flat[x.size - rem:]
        body = body.reshape(-1, x.shape[1]).astype(np.int64)
        tail = tail[: tail.size // x.shape[1] * x.shape[1]].reshape(
            -1, x.shape[1]).astype(np.int64)
        if op == tquery.Operation.REDUCE_SUM:
            s = body.sum(axis=0) & 0xFFFFFFFF
            return (s - ((s & 0x80000000) << 1)) + tail.sum(axis=0)
        rows = x.astype(np.int64)
        return (rows.max(axis=0) if op == tquery.Operation.REDUCE_MAX
                else rows.min(axis=0))

    q_paths = {}

    def run_queries(which):
        for case in q_cases:
            x, buf = streams[case[0]], q_bufs[case]
            for op in which:
                for mat in (False, True):
                    res = tquery.query(buf, tquery.QueryParams(op, mat),
                                       case[1], x.dtype.itemsize,
                                       device="cuda")
                    q_paths[case, op, mat] = tquery.pushdown.last_path
                    if mat and not np.array_equal(res.data, x):
                        raise AssertionError(f"query {case} {op} "
                                             f"materialized data differs")
                    if op == tquery.Operation.NOOP:
                        continue
                    got = getattr(res, op.name.split("_")[1].lower())
                    if not np.array_equal(np.asarray(got, np.int64),
                                          expected(x, buf, op)):
                        raise AssertionError(
                            f"query {case} {op} materialize {mat}: {got} "
                            f"differs from numpy")
        return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    zero_counts()
    q_launches = run_queries(ops[1:])
    host_calls("query", {"walk_headers", "gather_blocks", "gather_dims"})
    log(f"[query] launches: {json.dumps(q_launches)}")
    missing = [k for k in QUERY_PATH if q_launches[k] == 0]
    if missing:
        raise AssertionError(f"query path never launched: {missing}")
    stray = {k: q_launches[k] for k in QUERY_NEVER if q_launches[k]}
    n_xff = sum(c[1] == "xff" for c in q_cases) * (len(ops) - 1) * 2
    if stray or q_launches["reduce_cols"] != n_xff:
        raise AssertionError(
            f"query path: the delta queries launched {stray} (plain K2 / "
            f"lowdim decode), reduce_cols {q_launches['reduce_cols']} times "
            f"(the xff queries' {n_xff})")
    zero_counts()
    noop_launches = run_queries(ops[:1])
    log(f"[query] NOOP queries (a decode) launches: "
        f"{json.dumps({k: v for k, v in noop_launches.items() if v})}")
    q_launches = {k: q_launches[k] + noop_launches[k] for k in KERNELS}
    for case in q_cases:
        paths = {q_paths[case, op, False] for op in ops[1:]}
        if paths != {case[2]}:
            raise AssertionError(f"query {case}: paths {paths} without "
                                 f"materialize, not {case[2]}")
    wrap = expected(streams["u16 top 8 MiB"], q_bufs[q_cases[2]],
                    tquery.Operation.REDUCE_SUM)
    if not (wrap < 0).any():
        raise AssertionError("the u16 top stream's sums did not wrap")
    launches = {k: launches[k] + q_launches[k] for k in KERNELS}

    def query_values(buf: bytes, es: int, codec: str, compact: bool):
        """The values a query's reduce takes: the whole timeline, or the
        data blocks alone with the gap after each (the compact pass)."""
        ng, _, nd = read_metadata_rle(buf)
        lowdim = nd <= LOWDIM_MAX_NDIMS[es]
        idx = decoder.walk_headers(buf, ng, nd, es, lowdim)
        up = decoder.upload_payload(decoder.gather_payloads(buf, idx), idx,
                                    dev)
        if not compact:
            return decoder.decode_device(*up, idx.total_rows, es, codec,
                                         lowdim), None, False
        nd8 = idx.widths.shape[0] * 8
        gaps = np.diff(idx.out_rows, append=idx.total_rows) - 8
        return (decoder.decode_device(up[0], up[1], None, nd8, es, codec,
                                      lowdim),
                torch.from_numpy(gaps.astype(np.int32)).to(dev),
                bool(idx.out_rows[0] > 0))

    def epilogue_inputs(buf: bytes, es: int):
        """A delta query stream's epilogue inputs: the data blocks' payload
        with each one's gap and the leading run (the compact pass), and
        the whole timeline's (the fused pass); K1's outputs of each for K2
        (row-major), or the payload itself (lowdim)."""
        ng, _, nd = read_metadata_rle(buf)
        lowdim = nd <= LOWDIM_MAX_NDIMS[es]
        idx = decoder.walk_headers(buf, ng, nd, es, lowdim)
        dense, widths, out_rows = decoder.upload_payload(
            decoder.gather_payloads(buf, idx), idx, dev)
        gaps = np.diff(idx.out_rows, append=idx.total_rows) - 8
        full = decoder.place_blocks(dense, widths, out_rows, idx.total_rows)
        out = {"lowdim": lowdim, "eb": 8 * es, "nd": nd}
        for what, (d, w), g, lead in (
                ("data blocks", (dense, widths),
                 torch.from_numpy(gaps.astype(np.int32)).to(dev),
                 bool(idx.out_rows[0] > 0)),
                ("timeline", full, None, False)):
            if lowdim:
                out[what] = ((d, w), g, lead)
            else:
                bz, toff = dk.unpack_zz(d, w, 8 * es)
                out[what] = ((bz.reshape(-1, nd), toff), g, lead)
        return out

    def epilogue_calls(e):
        """(what, kernel, plain, op, gaps, leading_gap, store) of a stream:
        each op, store flag and gap setting."""
        name = "decode_lowdim_reduce" if e["lowdim"] else "prefix_finish_reduce"
        kern = qk.decode_lowdim_reduce if e["lowdim"] else qk.prefix_finish_reduce
        plain = (qk.decode_lowdim_reduce_plain if e["lowdim"]
                 else qk.prefix_finish_reduce_plain)
        for what in ("data blocks", "timeline"):
            args, g, lead = e[what]
            for op in qk.OPS:
                for store in (False, True):
                    for gl in ((None, False), (g, lead)) if g is not None else (
                            (None, False),):
                        yield (name, what, args, kern, plain, op, *gl, store)

    q_vals, q_epi = {}, {}
    n_epi = 0
    for case in q_cases:
        es = streams[case[0]].dtype.itemsize
        vals, gaps, lead = q_vals[case] = query_values(
            q_bufs[case], es, case[1], case[2] == "compact")
        for op in qk.OPS:
            for g in ((None, False), (gaps, lead)) if gaps is not None else (
                    (None, False),):
                check("reduce_cols", qk.reduce_cols(vals, op, *g),
                      qk.reduce_cols_plain(vals, op, *g),
                      f"{case[0]} {case[1]} {op}"
                      + (" with gaps" if g[0] is not None else ""))
        if case[1] != "delta":
            continue
        e = q_epi[case] = epilogue_inputs(q_bufs[case], es)
        plain_vals = {}
        for name, what, args, kern, plain, op, g, ld, store in epilogue_calls(e):
            got = kern(*args, e["eb"], op, g, ld, store)
            if what not in plain_vals:  # the plain decode, once a layout
                plain_vals[what] = plain(*args, e["eb"], "max")[0]
            want = (plain_vals[what] if store else None,
                    qk.reduce_cols_plain(plain_vals[what], op,
                                         g if op == "sum" else None, ld))
            desc = (f"{case[0]} {what} {op}" + (" with gaps" if g is not None
                                                 else "")
                    + (" store" if store else ""))
            if (got[0] is None) != (want[0] is None):
                raise AssertionError(f"{name} {desc}: values returned "
                                     f"{got[0] is not None}")
            check(name, got if store else got[1],
                  want if store else want[1], desc)
            n_epi += 1
    log(f"[query] {len(q_cases)} streams x {len(ops)} ops x materialize: "
        f"results == numpy (sums wrapped to int32 on the device's share; the "
        f"u16 top stream's sums {wrap.tolist()[:3]}...), paths "
        f"{sorted({c[2] for c in q_cases})}; the delta queries launched no "
        f"plain K2, plain lowdim decode or reduce_cols, the xff queries "
        f"reduce_cols {n_xff} times; {n_epi} epilogue launches == their "
        f"plain versions (every op, store flag and gap setting) and "
        f"reduce_cols == its plain version on every stream's values; the "
        f"phase {time.perf_counter() - t_phase:.1f} s")

    # ----------------------------------------------------------- 3g. cli
    # python -m sprintz_tpu_torch compress / decompress / info / query in a
    # subprocess each, all eight at once, on the 8 MiB u8 walk as a raw
    # file, delta and xff (whose container carries a sidecar): each
    # compress must write the API's container, and the reads of the API's
    # containers must give the raw file, a valid info and numpy's sums.
    t_phase = time.perf_counter()
    cli_dir = here / "build" / "cli_smoke"
    cli_dir.mkdir(parents=True, exist_ok=True)
    x = streams["u8 walk 8 MiB"]
    raw = cli_dir / "raw.bin"
    x.tofile(raw)
    codecs = ("delta", "xff")
    api = {}
    for c in codecs:
        cd = SprintzCodec(c, 1, device="cuda")
        if c == "xff":
            stream, sc = cd.compress_seekable(x)
            sc_b = sc.to_bytes()
            api[c] = (b"SPZT2" + bytes([1 | 1 << 5])
                      + np.uint32(len(sc_b)).tobytes() + sc_b + stream)
        else:
            api[c] = b"SPZT2" + bytes([0]) + cd.compress(x)
        (cli_dir / f"{c}.api.spz").write_bytes(api[c])
    argvs = {}
    for c in codecs:
        src = str(cli_dir / f"{c}.api.spz")
        argvs["compress", c] = ["compress", str(raw), str(cli_dir / f"{c}.spz"),
                                "--ndims", "64", "--codec", c]
        argvs["decompress", c] = ["decompress", src, str(cli_dir / f"{c}.out")]
        argvs["info", c] = ["info", src]
        argvs["query", c] = ["query", src, "--op", "sum"]
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", "sprintz_tpu_torch", *a], cwd=here,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, a in argvs.items()}
    outs = {}
    for k, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        if proc.returncode:
            raise AssertionError(f"cli {' '.join(k)}: rc {proc.returncode}: "
                                 f"{err}")
        outs[k] = out
    cli_s = time.perf_counter() - t0
    for c in codecs:
        if (cli_dir / f"{c}.spz").read_bytes() != api[c]:
            raise AssertionError(f"cli {c}: the container is not the API's "
                                 f"bytes")
        if (cli_dir / f"{c}.out").read_bytes() != raw.read_bytes():
            raise AssertionError(f"cli {c}: decompress differs from the raw "
                                 f"file")
        if "valid:     True" not in outs["info", c]:
            raise AssertionError(f"cli {c}: info says {outs['info', c]}")
        if (json.loads(outs["query", c])
                != x.sum(axis=0, dtype=np.int64).tolist()):
            raise AssertionError(f"cli {c}: query sums differ from numpy")
    log(f"[cli] compress, decompress, info and query on an 8 MiB file, "
        f"delta and xff (with its sidecar): 8 subprocesses at once in "
        f"{cli_s:.1f} s; containers == the API's bytes, files, info and sums "
        f"right; the phase {time.perf_counter() - t_phase:.1f} s")

    # -------------------------------------------------- 3h. distribution
    # sprintz_tpu_torch.parallel at the full width of the repo's streams:
    # meshes of 1, 2, 4 and 8 shards on the card (shard k on card k modulo
    # the cards), every count set to 0 just before and read just after.
    t_phase = time.perf_counter()
    ncards = torch.cuda.device_count()
    meshes = {n: pshard.make_mesh(devices=[f"cuda:{k % ncards}"
                                           for k in range(n)])
              for n in DIST_SHARDS}
    d_rowmajor = ("u8 walk 8 MiB", "u16 walk 8 MiB", "u8 runs 8 MiB")
    d_lowdim = ("u8 d4 walk 4 MiB", "u16 d2 walk 4 MiB")
    zero_counts()
    nchecked = 0
    for n, mesh in meshes.items():
        for w in d_rowmajor + d_lowdim:
            x = streams[w]
            es, nd = x.dtype.itemsize, x.shape[1]
            for c in ("delta", "xff"):
                what = f"{w} {c}, {n} shards"
                if w in d_rowmajor:
                    if pshard.dp_compress(mesh, x.reshape(-1), nd, c) != \
                            bufs[(w, c, "none")]:
                        raise AssertionError(f"dp_compress {what}: bytes "
                                             f"differ from compress's")
                if not np.array_equal(pshard.dp_decompress(
                        mesh, bufs[(w, c, "none")], c, es), x.reshape(-1)):
                    raise AssertionError(f"dp_decompress {what}: values "
                                         f"differ from the input")
                sc = sidecars[(w, c, "none")]
                if not np.array_equal(pshard.dp_decompress(
                        mesh, sk_bufs[(w, c, "none")], c, es, sidecar=sc),
                        x.reshape(-1)):
                    raise AssertionError(f"dp_decompress {what}, sidecar: "
                                         f"values differ from the input")
                nchecked += 1
        for w in d_lowdim:
            try:
                pshard.dp_compress(mesh, streams[w].reshape(-1),
                                   streams[w].shape[1])
            except ValueError:
                continue
            raise AssertionError(f"dp_compress {w}: wrote a lowdim stream")
    pdry.dryrun_multichip(4, ["cuda:0"] * 4)
    d_launches = {k: getattr(obj, attr) for k, (obj, attr) in
                  counters.items()}
    host_calls("distribution", HOST_DIST_PATH)
    log(f"[dist] launches: {json.dumps(d_launches)}")
    missing = [k for k in DIST_PATH if d_launches[k] == 0]
    if missing:
        raise AssertionError(f"distribution path never launched: {missing}")
    launches = {k: launches[k] + d_launches[k] for k in KERNELS}
    log(f"[dist] {nchecked} (stream, codec, mesh) cases at {DIST_SHARDS} "
        f"shards on {ncards} card(s): dp_compress == compress's bytes "
        f"(row-major), dp_decompress exact without and with the sidecar, "
        f"dp_compress refuses the lowdim ndims; dryrun_multichip(4) passed; "
        f"{time.perf_counter() - t_phase:.1f} s")
    # two processes over gloo sharing the card; the kernels and the host
    # library were built above, so the ranks do not build them again
    t0 = time.perf_counter()
    mp_dir = here / "build" / "mp_smoke"
    mp_dir.mkdir(parents=True, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        mp_port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sprintz_tpu_torch.parallel.mp_check",
         "--backend", "gloo", "--device", "cuda:0", "--out", str(mp_dir),
         "--large"], cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "MASTER_ADDR": "127.0.0.1",
                        "MASTER_PORT": str(mp_port), "WORLD_SIZE": "2",
                        "RANK": str(r)}) for r in range(2)]
    try:
        mp_logs = [proc.communicate(timeout=MP_TIMEOUT_S)[0] for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    for r, proc in enumerate(procs):
        ok = (mp_dir / f"rank{r}.out")
        if proc.returncode or not ok.exists() or \
                not ok.read_text().startswith("OK "):
            raise AssertionError(f"two-rank gloo: rank {r} rc "
                                 f"{proc.returncode}:\n{mp_logs[r][-4000:]}")
    log(f"[dist] two ranks over gloo on cuda:0: mp_compress == compress and "
        f"mp_decompress exact on {ok.read_text().split()[1:]} in "
        f"{time.perf_counter() - t0:.1f} s; the phase "
        f"{time.perf_counter() - t_phase:.1f} s")

    # ------------------------------------- 3i. the other codec formats
    t_phase = time.perf_counter()
    p_launches = {k: 0 for k in KERNELS}

    def window(what: str, fn, needed: set):
        """fn's result, its launches counted from 0: raise unless they are
        exactly the kernels in ``needed``; they join the current phase's
        counts (``p_launches``)."""
        zero_counts()
        out = fn()
        got = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
        ran = {k for k, v in got.items() if v}
        if ran != needed:
            raise AssertionError(f"{what}: launched {sorted(ran)}, must launch "
                                 f"exactly {sorted(needed)}")
        for k, v in got.items():
            p_launches[k] += v
        return out

    simple_bufs = {}
    for w in ("u8 walk 8 MiB", "u16 walk 8 MiB"):
        x = streams[w]
        es, flat = x.dtype.itemsize, x.reshape(-1)
        for c in simple.CODECS:
            buf = window(f"compress_simple {w} {c}",
                         lambda: simple.compress_simple(flat, 64, c),
                         SIMPLE_CALLS[(c, es, "encode")])
            out = window(f"decompress_simple {w} {c}",
                         lambda: simple.decompress_simple(buf, c, elem_sz=es),
                         SIMPLE_CALLS[(c, es, "decode")])
            if not np.array_equal(out, flat):
                raise AssertionError(f"simple {w} {c}: round trip differs")
            if simple.compress_simple(flat, 64, c, device="cpu") != buf:
                raise AssertionError(f"simple {w} {c}: card bytes differ from "
                                     f"the plain CPU run's")
            simple_bufs[(w, c)] = buf
            log(f"[formats] simple {w} {c}: {x.nbytes} B -> {len(buf)} B "
                f"(ratio {x.nbytes / len(buf):.4f}), bytes == CPU's, exact")

    # FIRE's transform instantiations over the whole walks against their
    # plain version, run on the host's CPU (a Python loop of launch-bound
    # steps: on an H100 it took about 5x the time of the host's CPU, 24 s
    # for both walks), whose one run is its plain time in section 4's rows
    # (host clock): at D 64 every row of the walk, at D 129 (odd: the u8
    # operand's parity alternates across a warp's dims) the xff transform's
    # head, the blocks that ``_xff_nblocks`` keeps
    def host_once(fn):
        c = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - c) * 1e3

    xf_inputs = {}
    for w in ("u8 walk 8 MiB", "u16 walk 8 MiB"):
        x = streams[w]
        es, flat = x.dtype.itemsize, x.reshape(-1)
        eb = 8 * es
        for nd in (64, 129):
            nrows = (x.shape[0] if nd == 64 else 8 * transforms._xff_nblocks(
                flat.size, nd, es))
            r = encoder.upload_rows(flat[:nrows * nd].reshape(nrows, nd), dev)
            r_host = r.cpu()
            want_e, ms_e = host_once(lambda: fc.fire_encode_plain(
                r_host, eb, transform=True))
            what = f"{w} D {nd}"
            check("fire_encode_transform",
                  fc.fire_encode(r, eb, transform=True), want_e.to(dev), what)
            raw_host = transform_raw(want_e, eb)
            raw = raw_host.to(dev)
            want_d, ms_d = host_once(lambda: fc.fire_decode_plain(
                raw_host, eb, transform=True))
            check("fire_decode_transform",
                  fc.fire_decode(raw, eb, transform=True), want_d.to(dev), what)
            if not torch.equal(dk.widen(want_d), r_host):
                raise AssertionError(f"FIRE transform {what}: the plain decode "
                                     f"does not give the stream back")
            xf_inputs[(w, nd)] = dict(rows=r, raw=raw, eb=eb, plain_ms={
                "fire_encode_transform": ms_e, "fire_decode_transform": ms_d})
            log(f"[kernels] FIRE's transform instantiations equal their plain "
                f"version over the whole {what} ({nrows // 8} blocks; plain "
                f"encode {ms_e:.1f} ms, decode {ms_d:.1f} ms on the host's "
                f"CPU)")

    for w in ("u8 walk 8 MiB", "u16 walk 8 MiB"):
        x = streams[w]
        es, flat = x.dtype.itemsize, x.reshape(-1)
        for tk in transforms.KINDS:
            for nd in (64, 5, 129):
                what = f"transform {tk} {w} D {nd}"
                buf = window(what, lambda: transforms.transform_encode(
                    flat, tk, ndims=nd),
                    TRANSFORM_CALLS.get(f"{tk} encode", set()))
                out = window(what, lambda: transforms.transform_decode(
                    buf, tk, es), TRANSFORM_CALLS.get(f"{tk} decode", set()))
                if not np.array_equal(out, flat):
                    raise AssertionError(f"{what}: round trip differs")
                if tk != "xff":
                    same = buf == transforms.transform_encode(
                        flat, tk, ndims=nd, device="cpu")
                elif (w, nd) in xf_inputs:
                    # the plain run's errors and the lag-D tail
                    head = transforms._xff_nblocks(flat.size, nd, es) * 8 * nd
                    body = flat.copy()
                    body[:head] = decoder.download_values(
                        xf_inputs[(w, nd)]["raw"]).view(flat.dtype)[:head]
                    body[head:] = flat[head:] - flat[head - nd: flat.size - nd]
                    same = buf == buf[:6] + body.tobytes()
                else:  # a prefix of 4096 rows and a partial row
                    m = 4096 * nd + nd // 2 + 1
                    same = (transforms.transform_encode(flat[:m], tk, ndims=nd)
                            == transforms.transform_encode(
                                flat[:m], tk, ndims=nd, device="cpu"))
                if not same:
                    raise AssertionError(f"{what}: bytes differ from the "
                                         f"plain version's")
        log(f"[formats] transforms {w}: every kind at D 64, 5 and 129 exact, "
            f"bytes == the plain version's")

    # the univariate facade: "sprintz" (the lowdim path at D 1) on a 4 MiB
    # walk, and every host method on small walks
    x1 = walk_stream(xrng, 1 << 22, 1, 1).reshape(-1)
    for c in ("delta", "xff"):
        buf = window(f"compress_univariate {c}",
                     lambda: univariate.compress_univariate(x1, codec=c),
                     UNIVARIATE_CALLS[(c, "encode")])
        out = window(f"decompress_univariate {c}",
                     lambda: univariate.decompress_univariate(buf, codec=c),
                     UNIVARIATE_CALLS[(c, "decode")])
        if not np.array_equal(out, x1):
            raise AssertionError(f"univariate sprintz {c}: round trip differs")
        pre = x1[:1 << 15]
        if (univariate.compress_univariate(pre, codec=c)
                != univariate.compress_univariate(pre, codec=c, device="cpu")):
            raise AssertionError(f"univariate sprintz {c}: card bytes differ "
                                 f"from the CPU's on a 32k prefix")
        log(f"[formats] univariate sprintz {c} 4 MiB: ratio "
            f"{x1.nbytes / len(buf):.4f}, exact")
    for m in HOST_METHODS:
        es = 1 if m.endswith("8b") else 2
        xs = walk_stream(xrng, 4099, 1, es).reshape(-1)
        if not np.array_equal(univariate.decompress_univariate(
                univariate.compress_univariate(xs, method=m), method=m,
                elem_sz=es), xs):
            raise AssertionError(f"univariate {m}: round trip differs")
    log(f"[formats] univariate host methods {', '.join(HOST_METHODS)}: exact")
    missing = [k for k in FORMATS_PATH if p_launches[k] == 0]
    if missing:
        raise AssertionError(f"the formats path never launched {missing}")
    log(f"[formats] launches: {json.dumps(p_launches)}")
    launches = {k: launches[k] + p_launches[k] for k in KERNELS}
    log(f"[formats] every call launched exactly its kernels; the phase "
        f"{time.perf_counter() - t_phase:.1f} s")

    # -------------------------------------------- 3j. the off-codec modules
    # search, the filter-bank search, the DataFrame pipeline, the dataset
    # layer, the device timer and the profiler hook; each call in a
    # counting window of its own (``window``, into this phase's counts)
    t_phase = time.perf_counter()
    p_launches = {k: 0 for k in KERNELS}
    orng = np.random.default_rng(SEED + 17)
    off_dir = here / "build" / "offcodec_smoke"
    shutil.rmtree(off_dir, ignore_errors=True)
    off_dir.mkdir(parents=True)

    def codec_calls(codec: str, es: int, ndims: int, side: str) -> set:
        """The kernels one compress or decompress launches: the lowdim
        ones at D <= LOWDIM_MAX_NDIMS (the univariate façade's), else the
        row-major ones (the simple codecs launch the same)."""
        if ndims <= LOWDIM_MAX_NDIMS[es]:
            return UNIVARIATE_CALLS[(codec, side)]
        return SIMPLE_CALLS[(codec, es, side)]

    def ev_ms(fn, reps: int = 5) -> float:
        """Median card time of fn over reps runs after a warm-up (CUDA
        events; fn's own host reads inside)."""
        fn()
        return statistics.median(once_ms(fn)[1] for _ in range(reps))

    # search at full width: X the 64 MiB u8 walk's rows as float32, with
    # ties planted (256 of the query rows copied to 3 other rows each), Q
    # 1024 of its rows, each moved by +-1 in 3 dims. Every distance is an
    # integer below 2^24, exact in float32: the answers must equal a
    # float64 brute force exactly, in lax.top_k's order (the lower index
    # first among equal distances)
    Xs = streams["u8 walk 64 MiB"].astype(np.float32)
    n_x, n_q = Xs.shape[0], 1024
    src = orng.choice(n_x, n_q, replace=False)
    Xs[orng.choice(n_x, 3 * 256, replace=False)] = np.repeat(
        Xs[src[:256]], 3, axis=0)
    Qs = Xs[src].copy()
    nudged = np.argsort(orng.random((n_q, Xs.shape[1])), axis=1)[:, :3]
    Qs[np.arange(n_q)[:, None], nudged] += orng.choice([-1.0, 1.0], (n_q, 3))
    Xd, Qd = torch.from_numpy(Xs).to(dev), torch.from_numpy(Qs).to(dev)
    X64 = Xs.astype(np.float64)
    xn64 = (X64 * X64).sum(axis=1)

    def brute(nq: int) -> np.ndarray:
        """float64 (N, nq) squared distances to the first nq queries."""
        Q64 = Qs[:nq].astype(np.float64)
        return (xn64[:, None] - 2.0 * (X64 @ Q64.T)
                + (Q64 * Q64).sum(axis=1)[None, :])

    def search_answers():
        return (window("knn_batch", lambda: tsearch.knn_batch(
                    Xd, Qd, 10), set()),
                window("knn_tiled", lambda: tsearch.knn_tiled(
                    Xd, Qd, 10, tile_rows=SEARCH_TILE), set()),
                window("onenn_batch", lambda: tsearch.onenn_batch(Xd, Qd),
                       set()),
                window("radius_batch", lambda: tsearch.radius_batch(
                    Xd, Qd[:64], RADIUS_SQ), set()))

    answers = search_answers()
    knn_b, knn_t, one, rad = answers
    if knn_t != knn_b or one != [nb[0] for nb in knn_b]:
        raise AssertionError("search: knn_batch, knn_tiled and onenn_batch "
                             "disagree")
    d64 = brute(16)
    for j in range(16):
        order = np.argsort(d64[:, j], kind="stable")[:10]
        if knn_b[j] != [tsearch.Neighbor(int(i), float(d64[i, j]))
                        for i in order]:
            raise AssertionError(f"search: query {j}'s knn differs from the "
                                 f"float64 brute force")
    d64 = brute(64)
    want = []
    for j in range(64):
        rows = np.flatnonzero(d64[:, j] < RADIUS_SQ)
        want.append([tsearch.Neighbor(int(i), float(d64[i, j])) for i in
                     rows[np.argsort(d64[rows, j], kind="stable")]])
    if rad != want:
        raise AssertionError("search: radius_batch differs from numpy's lists")
    ties = sum(len({nb.dist for nb in q}) < len(q) for q in knn_b)
    # again with TF32 switched on globally: the same answers, and the
    # caller's setting as it was. The walk's values (< 2^11) are exact in
    # TF32 too, so a tile of them divided by 3 shows that the pin acts: a
    # bare matmul of it under TF32 differs from the exact one, the port's
    # distances do not
    Xf = Xd[:SEARCH_TILE] / 3
    with exact_fp32_matmul():
        exact = torch.matmul(Xf, Qd.T)
    pinned = tsearch.squared_dists(Xf, Qd)
    torch.set_float32_matmul_precision("high")
    try:
        inexact = int((torch.matmul(Xf, Qd.T) != exact).sum())
        same_pinned = torch.equal(tsearch.squared_dists(Xf, Qd), pinned)
        tf32_answers = search_answers()
        setting = (torch.get_float32_matmul_precision(),
                   torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.set_float32_matmul_precision("highest")
    if (tf32_answers != answers or not same_pinned
            or setting != ("high", True)):
        raise AssertionError(f"search with TF32 on: answers or distances "
                             f"differ, or the setting changed ({setting})")
    s_ms = {"squared_dists": ev_ms(lambda: tsearch.squared_dists(Xd, Qd)),
            "knn_batch": ev_ms(lambda: tsearch.knn_batch(Xd, Qd, 10)),
            "knn_tiled": ev_ms(lambda: tsearch.knn_tiled(
                Xd, Qd, 10, tile_rows=SEARCH_TILE))}
    s_bounds = {"operations": 2 * n_x * n_q * Xs.shape[1] / CORE_OPS_PER_S,
                "bytes": n_x * n_q * 4 / mem_rate}
    s_by = max(s_bounds, key=s_bounds.get)
    log(f"[offcodec] search X {n_x} x {Xs.shape[1]}, Q {n_q}, k 10: "
        f"knn_batch == knn_tiled (tile {SEARCH_TILE}) == onenn_batch == the "
        f"float64 brute force on 16 queries ({ties} of {n_q} lists with "
        f"ties), radius_batch ({RADIUS_SQ}) == numpy on 64 "
        f"({sum(map(len, rad))} neighbours); the same with TF32 on, and "
        f"the distances of a tile / 3 bit for bit (a bare matmul of it then "
        f"differs at {inexact} of {SEARCH_TILE * n_q} entries)")
    log(f"[offcodec] search times on {smi}: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in s_ms.items())
        + f"; bound {s_bounds[s_by] * 1e3:.4f} ms by {s_by} (operations "
        f"{s_bounds['operations'] * 1e3:.4f}, the (N, Q) matrix's bytes "
        f"{s_bounds['bytes'] * 1e3:.4f})")
    del Xd, Qd, Xf, exact, pinned

    # the filter-bank search at the reference's defaults (nbits 4, ntaps
    # 4: 65536 candidates, chunk 4096) on 65536 samples of the ucr_like
    # corpus; each round's pick's objective against a float64
    # recomputation, and no sampled candidate better by more than 1e-4;
    # at a reduced grid, the picks the CPU run's under the tests' rule
    fx = tcorpus.synthetic_corpus("ucr_like", nrows=(1 << 16) + 4,
                                  seed=SEED)[:, 0].astype(np.float32)
    grid = tlearn.all_possible_filters(4, 4, 0.5)
    sample = grid[orng.choice(len(grid), 64, replace=False)]

    def same_picks(got, ref, kw) -> bool:
        """The tests' rule: equal, or the first differing round's picks
        within 1e-4 of each other by a float64 recomputation."""
        cands = tlearn.all_possible_filters(kw["ntaps"], kw["nbits"], 0.5)
        for i, (g, w) in enumerate(zip(got, ref)):
            if not np.array_equal(g, w):
                means = tlearn.candidate_means_plain(
                    fx, ref[:i], cands, kw["ntaps"], kw["block_sz"],
                    kw["loss"], kw["max_samples"])
                mg, mw = (means[np.flatnonzero((cands == v).all(axis=1))[0]]
                          for v in (g, w))
                return abs(mg - mw) <= 1e-4 * abs(mw)
        return True

    learn_rows = {}
    for loss in ("l2", "l1", "linf"):
        for bs in (1, 8):
            what = f"{loss} block {bs}"
            f, obj, round_s = window(
                f"greedy_search {what}",
                lambda: tlearn.greedy_search(fx, block_sz=bs, loss=loss),
                set())
            for i in range(len(f)):
                m = tlearn.candidate_means_plain(
                    fx, f[:i], np.vstack([f[i:i + 1], sample]), 4, bs, loss)
                if abs(obj[i] - m[0]) > 1e-4 * abs(m[0]):
                    raise AssertionError(f"greedy_search {what} round {i}: "
                                         f"objective {obj[i]} vs float64 "
                                         f"{m[0]}")
                if (m[1:] < m[0] * (1 - 1e-4)).any():
                    raise AssertionError(f"greedy_search {what} round {i}: a "
                                         f"sampled candidate beats the pick")
            kw = dict(ntaps=3, nbits=3, max_samples=8192, block_sz=bs,
                      loss=loss)
            g = window(f"greedy_search {what} reduced",
                       lambda: tlearn.greedy_search(fx, **kw), set())[0]
            c = tlearn.greedy_search(fx, device="cpu", **kw)[0]
            if not same_picks(g, c, kw):
                raise AssertionError(f"greedy_search {what}: the reduced "
                                     f"grid's picks differ from the CPU run's")
            learn_rows[what] = [round(float(t) * 1e3, 4) for t in round_s]
            log(f"[offcodec] filter-bank search {what}: filters "
                f"{f.tolist()}, objective {obj.tolist()} (float64 within "
                f"1e-4); rounds {learn_rows[what]} ms; reduced grid == CPU "
                f"{'exactly' if np.array_equal(g, c) else 'within 1e-4'}")
    log(f"[offcodec] filter-bank rounds (host clock, ms) on {smi}: "
        + json.dumps(learn_rows))

    # the DataFrame pipeline: a stand-in frame (``.columns``,
    # ``frame[c].to_numpy()``, no pandas) of 1M rows through codec chains
    # with encode_measure_decode; the Sprintz columns (u8 / u16: the
    # walks, the quantized prices, the flags) take the lowdim path at D 1
    # on the card, their bytes the CPU run's (xff: a 32k-row prefix);
    # DynamicDelta, a host codec of about 11 us a sample, on a 64k-row
    # prefix
    n_f = 1 << 20
    cols = {"u8 walk": walk_stream(orng, n_f, 1, 1)[:, 0],
            "u16 walk": walk_stream(orng, n_f, 1, 2)[:, 0],
            "i32 walk": np.cumsum(orng.integers(-100, 101, n_f)).astype(
                np.int32),
            "price": np.round(100 + np.cumsum(orng.normal(0, 0.05, n_f)), 2),
            "flags": orng.integers(0, 2, n_f).astype(np.uint8)}
    lowdim_calls = {c: codec_calls(c, 1, 1, "encode") | codec_calls(
        c, 1, 1, "decode") for c in ("delta", "xff")}
    chains = {
        "quantize delta zigzag zlib": (lambda: [
            fcodecs.Quantize(), fcodecs.Delta(), fcodecs.Zigzag(),
            fcodecs.Zlib()], n_f, set()),
        "codecsearch zlib": (lambda: [fcodecs.CodecSearch(), fcodecs.Zlib()],
                             n_f, set()),
        "quantize dynamicdelta zigzag zlib": (lambda: [
            fcodecs.Quantize(), fcodecs.DynamicDelta(), fcodecs.Zigzag(),
            fcodecs.Zlib()], 1 << 16, set()),
        "quantize sprintz delta": (lambda: [
            fcodecs.Quantize(), fcodecs.Sprintz("delta")], n_f,
            lowdim_calls["delta"]),
        "quantize sprintz xff": (lambda: [
            fcodecs.Quantize(), fcodecs.Sprintz("xff")], n_f,
            lowdim_calls["xff"]),
    }
    frame_rows = {}
    for name, (chain, rows, needed) in chains.items():
        fr = Frame({c: v[:rows] for c, v in cols.items()})
        c0 = time.perf_counter()
        res = window(f"frames {name}",
                     lambda: tframes.encode_measure_decode([fr], chain()),
                     needed)
        sec = time.perf_counter() - c0
        if not res.lossless:
            raise AssertionError(f"frames {name}: not lossless")
        frame_rows[name] = {"rows": rows, "bytes": res.orig_nbytes,
                            "encoded": res.encoded_nbytes,
                            "ratio": res.ratio, "e2e_s": sec}
        log(f"[offcodec] frames {name} ({rows} rows): {res.orig_nbytes} B "
            f"-> {res.encoded_nbytes} B (ratio {res.ratio:.4f}), lossless, "
            f"encode + decode {sec * 1e3:.1f} ms")
    for codec in ("delta", "xff"):
        rows = n_f if codec == "delta" else FIRE_PLAIN_ROWS
        fr = {"f": Frame({c: v[:rows] for c, v in cols.items()})}
        card = window(f"frames encode sprintz {codec}", lambda: tframes.encode(
            fr, [fcodecs.Quantize(), fcodecs.Sprintz(codec)]),
            codec_calls(codec, 1, 1, "encode"))
        cpu = tframes.encode(fr, [fcodecs.Quantize(),
                                  fcodecs.Sprintz(codec, device="cpu")])
        if json.dumps(card[1]) != json.dumps(cpu[1]) or any(
                card[0]["f"][c].tobytes() != cpu[0]["f"][c].tobytes()
                for c in cols):
            raise AssertionError(f"frames sprintz {codec}: card bytes differ "
                                 f"from the CPU run's")
    log(f"[offcodec] frames: the Sprintz columns' bytes == the CPU run's "
        f"(delta {n_f} rows, xff {FIRE_PLAIN_ROWS}); on {smi}: "
        + json.dumps(frame_rows))

    # the dataset layer: each synthetic corpus at 100k rows, u8 and u16,
    # through write_dat / read_dat and the codec on the card
    corpus_rows = {}
    for name, prof in tcorpus.CORPUS_PROFILES.items():
        for dt in (np.uint8, np.uint16):
            mat = tcorpus.synthetic_corpus(name, nrows=100_000, dtype=dt,
                                           seed=SEED)
            es, nd = mat.dtype.itemsize, prof["ndims"]
            back = tcorpus.read_dat(tcorpus.write_dat(
                off_dir / "corpora", name, mat), dt, nd)
            if not np.array_equal(back, mat):
                raise AssertionError(f"corpus {name}: write_dat / read_dat "
                                     f"round trip differs")
            for codec in ("delta", "xff"):
                what = f"{name} {np.dtype(dt).name} {codec}"
                sc = SprintzCodec(codec, es, device="cuda")
                c0 = time.perf_counter()
                buf = window(f"compress {what}", lambda: sc.compress(mat),
                             codec_calls(codec, es, nd, "encode"))
                c1 = time.perf_counter()
                out = window(f"decompress {what}", lambda: sc.decompress(buf),
                             codec_calls(codec, es, nd, "decode"))
                c2 = time.perf_counter()
                if not np.array_equal(out, mat.reshape(-1)):
                    raise AssertionError(f"corpus {what}: round trip differs")
                if codec == "delta" and buf != SprintzCodec(
                        codec, es, device="cpu").compress(mat):
                    raise AssertionError(f"corpus {what}: card bytes differ "
                                         f"from the CPU run's")
                corpus_rows[what] = {"ndims": nd, "bytes": mat.nbytes,
                                     "ratio": mat.nbytes / len(buf),
                                     "compress_s": c1 - c0,
                                     "decompress_s": c2 - c1}
    log("[offcodec] corpora (100k rows; lossless, delta bytes == the CPU "
        "run's, write_dat / read_dat exact), ratios: " + ", ".join(
            f"{k} {v['ratio']:.4f}" for k, v in corpus_rows.items()))
    log(f"[offcodec] corpora on {smi}: " + json.dumps(corpus_rows))

    # the device timer: K1's wrapper at the 8 MiB u8 walk, 64 calls back to
    # back (held to phase 4's CUDA-event median there); the profiler hook
    # around one decompress of the 8 MiB u8 walk, in an annotated range
    k1_in = inputs["u8 main (nb 16384, D 64)"]
    loop_s = window("device_loop_time K1", lambda: ttiming.device_loop_time(
        dk.unpack_zz, (k1_in["dense"], k1_in["dwidths"], k1_in["eb"]),
        iters=64), {"unpack_zz"})
    trace_dir = off_dir / "trace"
    cd = SprintzCodec("delta", 1, device="cuda")
    tbuf = bufs[("u8 walk 8 MiB", "delta", "none")]

    def profiled():
        with ttrace.device_profile(str(trace_dir)):
            with ttrace.annotate("offcodec decompress"):
                return cd.decompress(tbuf)

    if not np.array_equal(window("device_profile decompress", profiled,
                                 codec_calls("delta", 1, 64, "decode")),
                          streams["u8 walk 8 MiB"].reshape(-1)):
        raise AssertionError("profiled decompress: round trip differs")
    traces = list(trace_dir.glob("*.pt.trace.json"))
    events = json.loads(traces[0].read_text())["traceEvents"] if len(
        traces) == 1 else []
    kern = [e["name"] for e in events if e.get("cat") == "kernel"]
    named = {k: any(k in e for e in kern) for k in
             ("unpack_zz_kernel", "prefix_finish_kernel")}
    ranges = [e.get("cat") for e in events
              if e.get("name") == "offcodec decompress"]
    if not all(named.values()) or "user_annotation" not in ranges:
        raise AssertionError(f"device_profile: {len(traces)} traces, kernels "
                             f"{kern[:8]}, the range's events {ranges}")
    log(f"[offcodec] device_profile: {traces[0].name}, {len(events)} events, "
        f"{len(kern)} kernel events (unpack_zz_kernel, prefix_finish_kernel "
        f"among them), the annotated range as {sorted(set(ranges))}")
    missing = [k for k in OFFCODEC_PATH if p_launches[k] == 0]
    if missing:
        raise AssertionError(f"the off-codec path never launched {missing}")
    log(f"[offcodec] launches: {json.dumps(p_launches)}")
    launches = {k: launches[k] + p_launches[k] for k in KERNELS}
    log(f"[offcodec] every call launched exactly its kernels; the phase "
        f"{time.perf_counter() - t_phase:.1f} s")

    # -------------------------------------------------------- 4. timings
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            # Evict the 50 MB L2, so the path's inputs arrive cold. Writing
            # 1 GiB also keeps the card busy for about 0.3 ms, time for the
            # host to queue every launch of fn before the card reaches the
            # first: the events then time the card's work, not the host's
            # gaps between a wrapper's launches.
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def launch_ms(fn) -> float:
        """The card time inside fn's kernel launches alone (KernelClock),
        median of REPS calls after a warm-up, L2 flushed before each: the
        wrapper's own torch ops and host reads are left out."""
        fn()
        times = []
        for _ in range(REPS):
            flush.zero_()
            with KernelClock() as clock:
                fn()
            times.append(clock.seconds() * 1e3)
        return statistics.median(times)

    def chain_probe(paired: int) -> tuple[float, float]:
        """(cycles, nanoseconds) of one step of a one-warp loop of
        dependent integer multiply-adds, each followed by a shift if
        `paired`, by the SM's clock and the card's global timer."""
        out = torch.zeros(3, dtype=torch.int64, device=dev)
        for _ in range(2):  # the second run finds the clock up
            _build.launch("sprintz_fire_chain_probe", out, out.data_ptr(),
                          CHAIN_PROBE_ITERS, paired)
            torch.cuda.synchronize()
        cycles, ns = (int(v) for v in out[:2])
        return cycles / CHAIN_PROBE_ITERS, ns / CHAIN_PROBE_ITERS

    imad_cycles, imad_ns = chain_probe(0)
    pair_cycles, pair_ns = chain_probe(1)
    sm_hz = imad_cycles / imad_ns * 1e9
    smi_clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0]
    log(f"[timing] chain probe: one dependent multiply-add {imad_cycles:.4f} "
        f"cycles, {imad_ns:.4f} ns (SM clock {sm_hz / 1e9:.4f} GHz by the "
        f"card's timers, {smi_clock} by nvidia-smi); with a shift after it "
        f"{pair_cycles:.4f} cycles, {pair_ns:.4f} ns")

    def nbytes(*ts) -> int:
        return sum(t.numel() * t.element_size() for t in ts
                   if isinstance(t, torch.Tensor))

    def row(name, kern, plain, lib, nb_, nops, chain_steps=0, **extra):
        """plain: the plain version to time, or its time in ms already
        taken (FIRE's, from its one full-size run in the kernel checks), or
        None where it is not timed (FIRE at the 4 MiB lowdim streams).
        chain_steps: the dependent operations of its serial chain, each
        bounded by the probe's multiply-add."""
        bounds = {"bytes": nb_ / mem_rate, "operations": nops / CORE_OPS_PER_S,
                  "chain": chain_steps * imad_cycles / sm_hz}
        by = max(bounds, key=bounds.get)  # bytes on a tie
        return {
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": time_ms(kern),
            "kernel_ms": launch_ms(kern),
            "plain_ms": time_ms(plain) if callable(plain) else plain,
            "plain_on": "cuda", "bound_ms": bounds[by] * 1e3, "bound_by": by,
            "chain_bound_ms": bounds["chain"] * 1e3 if chain_steps else None,
            "bytes_bound_ms": bounds["bytes"] * 1e3,
            "library_ms": time_ms(lib) if lib else None, "bytes": nb_,
            **extra}

    def kernel_rows(a):
        eb, es = a["eb"], a["es"]
        # K2's function as one library call: the per-tile prefix of the
        # deltas (torch.cumsum has no uint16 kernel, so u16 goes as int16)
        bz_tiles = (a["bz"].view(torch.int16) if es == 2 else a["bz"]).view(
            -1, dk.TILE_ROWS, a["bz"].shape[1])
        out_k1 = dk.unpack_zz(a["dense"], a["dwidths"], eb)
        out_k3 = pk.pack_rows(a["blocks"], a["widths"], es)
        out_k4 = pk.unpack_rows(a["dense"], a["dwidths"])
        out_fd = fc.fire_decode(a["ferrs"], eb)
        nvals = a["bz"].numel()
        rows = [
            row("unpack_zz",
                lambda: dk.unpack_zz(a["dense"], a["dwidths"], eb),
                lambda: dk.unpack_zz_plain(a["dense"], a["dwidths"], eb),
                None, nbytes(a["dense"], a["dwidths"], *out_k1),
                OPS_PER_ELEM["unpack_zz"] * nvals),
            row("prefix_finish",
                lambda: dk.prefix_finish(a["bz"], a["toff"], eb),
                lambda: dk.prefix_finish_plain(a["bz"], a["toff"], eb),
                lambda: torch.cumsum(bz_tiles, dim=1, dtype=torch.int32),
                nbytes(a["bz"], a["toff"], a["bz"]),
                OPS_PER_ELEM["prefix_finish"] * nvals),
            row("pack_rows",
                lambda: pk.pack_rows(a["blocks"], a["widths"], es),
                lambda: pk.pack_rows_plain(a["blocks"], a["widths"], es),
                None, nbytes(a["blocks"], a["widths"], out_k3),
                OPS_PER_ELEM["pack_rows"] * nvals,
                # the interface takes i32 errors and widths; the packing
                # itself needs only the narrow errors, u8 widths and the
                # payload it writes
                packing_bytes=(a["blocks"].numel() * es
                               + a["widths"].numel() + nbytes(out_k3))),
            row("unpack_rows",
                lambda: pk.unpack_rows(a["dense"], a["dwidths"]),
                lambda: pk.unpack_rows_plain(a["dense"], a["dwidths"]),
                None, nbytes(a["dense"], a["dwidths"], out_k4),
                OPS_PER_ELEM["unpack_rows"] * nvals),
        ]
        if es == 1:
            rows.append(row(
                "unpack_rows_narrow",
                lambda: pk.unpack_rows(a["dense"], a["dwidths"], narrow=True),
                lambda: pk.unpack_rows_plain(a["dense"], a["dwidths"], True),
                None, nbytes(a["dense"], a["dwidths"]) + nvals,
                OPS_PER_ELEM["unpack_rows_narrow"] * nvals))
        # FIRE: the plain time is its one full-size run in the checks
        nblocks = a["rows"].shape[0] // 8
        rows += [
            row("fire_encode", lambda: fc.fire_encode(a["rows"], eb),
                a["fire_plain_ms"]["fire_encode"], None,
                2 * nbytes(a["rows"]), OPS_PER_ELEM["fire_encode"] * nvals,
                chain_steps=nblocks * CHAIN_OPS["fire_encode"][eb]),
            row("fire_decode", lambda: fc.fire_decode(a["ferrs"], eb),
                a["fire_plain_ms"]["fire_decode"], None,
                nbytes(a["ferrs"], out_fd),
                OPS_PER_ELEM["fire_decode"] * nvals,
                chain_steps=nblocks * CHAIN_OPS["fire_decode"][eb]),
        ]
        for r_ in rows:
            if "packing_bytes" in r_:
                r_["packing_bound_ms"] = r_["packing_bytes"] / mem_rate * 1e3
        return rows

    def huff_rows(h, plain_dec_once=False):
        """plain_dec_once: time the plain decode by one run (a Python loop
        of chunk_symbols steps)."""
        dec, enc = h["dec"], h["enc"]
        n = h["n"]
        out_e = hk.encode_chunks(*enc)
        # K6 reads each payload byte once, the chunk offsets and sizes and
        # the tables, and writes one byte per symbol and its overrun count;
        # the encoder reads the symbols and the tables, and writes the
        # sizes and the payload (its offsets are a cumsum between its two
        # passes)
        dec_bytes = h["payload"] + nbytes(*dec[1:6]) + n + 4
        enc_bytes = n + nbytes(*enc[1:3], *out_e)
        return [
            row("huff_decode", lambda: hk.decode_chunks(*dec),
                once_ms(lambda: hk.decode_chunks_plain(*dec))[1]
                if plain_dec_once else lambda: hk.decode_chunks_plain(*dec),
                None, dec_bytes, OPS_PER_ELEM["huff_decode"] * n),
            row("huff_encode", lambda: hk.encode_chunks(*enc),
                lambda: hk.encode_chunks_plain(*enc), None, enc_bytes,
                OPS_PER_ELEM["huff_encode"] * n),
        ]

    def log_rows(what, rows):
        for r in rows:
            lib, plain = r["library_ms"], r["plain_ms"]
            log(f"[timing] {what} {r['name']}: {r['ms']:.4f} ms (inside "
                f"its launches {r['kernel_ms']:.4f} ms), plain "
                + ("not timed at this size" if plain is None
                   else f"{plain:.4f} ms")
                + (" on the host's CPU" if r["plain_on"] == "cpu" else "")
                + f", bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}, "
                f"{r['bytes']} B"
                + (f", bytes bound {r['bytes_bound_ms']:.4f} ms, "
                   f"{r['ms'] / r['chain_bound_ms']:.2f}x its chain bound"
                   if r["chain_bound_ms"] else "") + "), library "
                f"{lib if lib is None else round(lib, 4)}"
                + (f", packing bound {r['packing_bound_ms']:.4f} ms "
                   f"({r['packing_bytes']} B)" if "packing_bytes" in r
                   else ""))

    table = {}
    for what in ("u8 main (nb 16384, D 64)", "u16 main (nb 8192, D 64)"):
        table[what] = kernel_rows(inputs[what])
        log_rows(what, table[what])
    # phase 3j's device_loop_time of K1 beside its CUDA-event median here
    k1_ms = next(r["ms"] for r in table["u8 main (nb 16384, D 64)"]
                 if r["name"] == "unpack_zz")
    loop_ratio = loop_s * 1e3 / k1_ms
    log(f"[offcodec] device_loop_time of K1 at the 8 MiB u8 walk: "
        f"{loop_s * 1e3:.4f} ms a call (64 back to back) beside the CUDA-event "
        f"median {k1_ms:.4f} ms: {loop_ratio:.3f}x")
    if not 0.5 <= loop_ratio <= 3.0:
        raise AssertionError(f"device_loop_time of K1 is {loop_ratio:.3f}x the "
                             f"CUDA-event median, outside 0.5-3x")
    # the Huffman rows at the headline's chunk size, and at 4096 on the
    # smooth stream's sprintz stream (whose plain decode takes 4096 Python
    # steps a call: timed once)
    huff_what = next(iter(huff))
    table[huff_what] = huff_rows(huff[huff_what])
    log_rows(huff_what, table[huff_what])
    table[huff_smooth[0]] = huff_rows(huff_smooth[1], plain_dec_once=True)
    log_rows(huff_smooth[0], table[huff_smooth[0]])
    # K3, K1 and K2 on the 64 MiB walk, whose i32 errors, payload and
    # values outgrow the 50 MB L2
    what = "u8 walk 64 MiB (nb 131072, D 64)"
    rows64 = encoder.upload_rows(streams["u8 walk 64 MiB"], dev)
    b64 = fc.delta_encode(rows64, 8).reshape(-1, 8, rows64.shape[1])
    w64 = block_widths_rowmajor(b64.amax(dim=1), 1)
    check("pack_rows", pk.pack_rows(b64, w64, 1),
          pk.pack_rows_plain(b64, w64, 1), what)
    table[what] = [row(
        "pack_rows", lambda: pk.pack_rows(b64, w64, 1),
        lambda: pk.pack_rows_plain(b64, w64, 1), None,
        nbytes(b64, w64) + b64.numel(), OPS_PER_ELEM["pack_rows"] * b64.numel(),
        packing_bytes=2 * b64.numel() + w64.numel())]
    table[what][0]["packing_bound_ms"] = (table[what][0]["packing_bytes"]
                                          / mem_rate * 1e3)
    del rows64, b64, w64
    buf64 = bufs[("u8 walk 64 MiB", "delta", "none")]
    idx64 = decoder.walk_headers(buf64, read_metadata_rle(buf64)[0], 64, 1)
    d64, dw64, _ = decoder.upload_payload(
        decoder.gather_payloads(buf64, idx64), idx64, dev)
    out64 = dk.unpack_zz(d64, dw64, 8)
    check("unpack_zz", out64, dk.unpack_zz_plain(d64, dw64, 8), what)
    bz64, toff64 = out64[0].reshape(-1, 64), out64[1]
    check("prefix_finish", dk.prefix_finish(bz64, toff64, 8),
          dk.prefix_finish_plain(bz64, toff64, 8), what)
    table[what] += [
        row("unpack_zz", lambda: dk.unpack_zz(d64, dw64, 8),
            lambda: dk.unpack_zz_plain(d64, dw64, 8), None,
            nbytes(d64, dw64, *out64), OPS_PER_ELEM["unpack_zz"] * bz64.numel()),
        row("prefix_finish", lambda: dk.prefix_finish(bz64, toff64, 8),
            lambda: dk.prefix_finish_plain(bz64, toff64, 8),
            lambda: torch.cumsum(bz64.view(-1, dk.TILE_ROWS, 64), dim=1,
                                 dtype=torch.int32),
            nbytes(bz64, toff64, bz64),
            OPS_PER_ELEM["prefix_finish"] * bz64.numel())]
    log_rows(what, table[what])
    del d64, dw64, out64, bz64, toff64

    def lowdim_rows(what, a):
        """The lowdim encode pass (from the rows and from FIRE's errors),
        the decode and its raw mode, and the full-precision FIRE kernels at
        a 4 MiB stream (the plain FIRE is timed at 32k rows, in
        ``fire_full_rows``)."""
        eb, es = a["eb"], a["es"]
        nr, fe32 = a["nrows"], a["ferrs"]
        out_e = pk.encode_lowdim(nr, es)
        out_f = pk.encode_lowdim(fe32, es, True)
        out_d = dk.decode_delta_lowdim(a["dense"], a["dwidths"], eb)
        out_r = dk.unpack_dims_lowdim(a["dense"], a["dwidths"])
        nvals = nr.numel()
        fe = fe32.to(torch.uint8) if eb == 8 else fe32
        out_fd = fc.fire_decode(fe, eb, truncate_coeffs=False)
        nblocks = a["rows"].shape[0] // 8
        return [
            row("encode_lowdim", lambda: pk.encode_lowdim(nr, es),
                lambda: pk.encode_lowdim_plain(nr, es), None,
                nbytes(nr, *out_e), OPS_PER_ELEM["encode_lowdim"] * nvals),
            row("encode_lowdim_errs", lambda: pk.encode_lowdim(fe32, es, True),
                lambda: pk.encode_lowdim_plain(fe32, es, True), None,
                nbytes(fe32, *out_f),
                OPS_PER_ELEM["encode_lowdim_errs"] * nvals),
            row("decode_lowdim",
                lambda: dk.decode_delta_lowdim(a["dense"], a["dwidths"], eb),
                lambda: dk.decode_delta_lowdim_plain(a["dense"], a["dwidths"],
                                                     eb),
                None, nbytes(a["dense"], a["dwidths"], out_d),
                OPS_PER_ELEM["decode_lowdim"] * nvals),
            row("unpack_lowdim_raw",
                lambda: dk.unpack_dims_lowdim(a["dense"], a["dwidths"]),
                lambda: dk.unpack_dims_lowdim_plain(a["dense"], a["dwidths"]),
                None, nbytes(a["dense"], a["dwidths"], out_r),
                OPS_PER_ELEM["unpack_lowdim_raw"] * nvals),
            row("fire_encode_full",
                lambda: fc.fire_encode(a["rows"], eb, truncate_coeffs=False),
                None, None, 2 * nbytes(a["rows"]),
                OPS_PER_ELEM["fire_encode_full"] * nvals,
                chain_steps=nblocks * CHAIN_OPS["fire_encode_full"][eb]),
            row("fire_decode_full",
                lambda: fc.fire_decode(fe, eb, truncate_coeffs=False),
                None, None, nbytes(fe, out_fd),
                OPS_PER_ELEM["fire_decode_full"] * nvals,
                chain_steps=nblocks * CHAIN_OPS["fire_decode_full"][eb]),
        ]

    def fire_full_rows(f):
        """The full-precision FIRE kernels at a 32k-row stream, beside the
        plain version's one run at the same size."""
        eb, r, fe = f["eb"], f["rows"], f["ferrs"]
        nvals, nblocks = r.numel(), r.shape[0] // 8
        out_fd = fc.fire_decode(fe, eb, truncate_coeffs=False)
        return [
            row("fire_encode_full",
                lambda: fc.fire_encode(r, eb, truncate_coeffs=False),
                f["plain_ms"]["fire_encode_full"], None, 2 * nbytes(r),
                OPS_PER_ELEM["fire_encode_full"] * nvals,
                chain_steps=nblocks * CHAIN_OPS["fire_encode_full"][eb]),
            row("fire_decode_full",
                lambda: fc.fire_decode(fe, eb, truncate_coeffs=False),
                f["plain_ms"]["fire_decode_full"], None, nbytes(fe, out_fd),
                OPS_PER_ELEM["fire_decode_full"] * nvals,
                chain_steps=nblocks * CHAIN_OPS["fire_decode_full"][eb]),
        ]

    for what, a in ld_inputs.items():
        table[what] = lowdim_rows(what, a)
        log_rows(what, table[what])
    for what, f in ld_fire.items():
        table[what] = fire_full_rows(f)
        log_rows(what, table[what])
    def seek_rows(what, k):
        """The sidecar's kernels at a stream: the chunked FIRE decode at its
        sidecar's chunks (the short-chunk kernel, beside the serial decode
        in the same call) and at chunks of 1024 groups (the ring kernel),
        the encode with its states (beside the encode without), and the
        chunked delta decode with the stream's own states (beside the
        serial decode; with every chunk moved too)."""
        a, eb, fe, trunc = k["a"], k["eb"], k["fe"], k["trunc"]
        sfx = "" if trunc else "_full"
        nvals = a["rows"].numel()
        dec = "fire_decode" + sfx
        out = []
        serial_ms = time_ms(lambda: fc.fire_decode(fe, eb, None, trunc))
        for first, states, kern in ((k["first"], k["states"], "fire_decode_short"),
                                    (k["lfirst"], k["lstates"], "fire_decode_chunks")):
            states = states.to(dev)
            longest = int(np.diff(first).max())
            out_fd = fc.fire_decode_chunks(fe, eb, first, states, trunc)
            # the plain version loops over the longest chunk's blocks: the
            # ring's chunks of 2048 blocks are timed by one run
            plain = (lambda: fc.fire_decode_chunks_plain(fe, eb, first, states,
                                                         trunc))
            out.append(row(
                kern + sfx,
                lambda: fc.fire_decode_chunks(fe, eb, first, states, trunc),
                plain if kern == "fire_decode_short" else once_ms(plain)[1],
                None, nbytes(fe, out_fd) + nbytes(states) + first.nbytes,
                OPS_PER_ELEM[dec] * nvals,
                chain_steps=longest * CHAIN_OPS[dec][eb], chunks=first.size - 1,
                serial_ms=serial_ms))
        r = a["rows"]
        enc = "fire_encode" + sfx
        out_c = fc.fire_encode(r, eb, trunc, states=True)
        out.append(row(
            "fire_encode_states" + sfx,
            lambda: fc.fire_encode(r, eb, trunc, states=True),
            a["fire_plain_ms"].get("fire_encode_states") if trunc else None,
            None, nbytes(r, *out_c), OPS_PER_ELEM[enc] * nvals,
            chain_steps=(r.shape[0] // 8) * CHAIN_OPS[enc][eb],
            no_states_ms=time_ms(lambda: fc.fire_encode(r, eb, trunc))))
        # the chunked delta decode: its kernels' bytes are the serial
        # ones' and the chunks' (C + 1 starts, C x D states)
        dense, dw, serial = a["dense"], a["dwidths"], k["serial"]
        dfirst, dst = k["dfirst"], k["dst"].to(dev)
        nchunks, nd = dst.shape
        nb = int(dfirst[-1])
        ck = dk.delta_chunks(dfirst, dst, nb, nd, dev)
        every = dk.delta_chunks(dfirst, moved(dst[:, None])[:, 0] + 1, nb, nd,
                                dev)  # every chunk moves
        cbytes = nbytes(dst) + dfirst.nbytes
        nv = serial.numel()
        extra = dict(chunks=nchunks, bytes_chunks=cbytes)
        if k["lowdim"]:
            out.append(row(
                "decode_lowdim_chunks",
                lambda: dk.decode_delta_lowdim(dense, dw, eb, ck),
                lambda: dk.decode_delta_lowdim_plain(dense, dw, eb, ck), None,
                nbytes(dense, dw, serial) + cbytes,
                OPS_PER_ELEM["decode_lowdim"] * nv,
                serial_ms=time_ms(lambda: dk.decode_delta_lowdim(dense, dw, eb)),
                moved_ms=time_ms(lambda: dk.decode_delta_lowdim(dense, dw, eb,
                                                                every)),
                **extra))
            return out
        bz, toff = dk.unpack_zz(dense, dw, eb, ck)
        bz = bz.reshape(-1, nd)
        sbz, stoff = dk.unpack_zz(dense, dw, eb)
        sbz = sbz.reshape(-1, nd)
        bz_e, toff_e = dk.unpack_zz(dense, dw, eb, every)
        bz_e = bz_e.reshape(-1, nd)
        out += [
            row("unpack_zz_chunks", lambda: dk.unpack_zz(dense, dw, eb, ck),
                lambda: dk.unpack_zz_plain(dense, dw, eb, ck), None,
                nbytes(dense, dw, bz, toff) + cbytes,
                OPS_PER_ELEM["unpack_zz"] * nv,
                serial_ms=time_ms(lambda: dk.unpack_zz(dense, dw, eb)),
                moved_ms=time_ms(lambda: dk.unpack_zz(dense, dw, eb, every)),
                **extra),
            row("prefix_finish_chunks",
                lambda: dk.prefix_finish(bz, toff, eb, ck),
                lambda: dk.prefix_finish_plain(bz, toff, eb, ck), None,
                nbytes(bz, toff, bz) + cbytes,
                OPS_PER_ELEM["prefix_finish"] * nv,
                serial_ms=time_ms(lambda: dk.prefix_finish(sbz, stoff, eb)),
                moved_ms=time_ms(lambda: dk.prefix_finish(bz_e, toff_e, eb,
                                                          every)),
                **extra)]
        return out

    def fire_states_full_rows(f):
        eb, r = f["eb"], f["rows"]
        out_c = fc.fire_encode(r, eb, truncate_coeffs=False, states=True)
        return [row(
            "fire_encode_states_full",
            lambda: fc.fire_encode(r, eb, truncate_coeffs=False, states=True),
            f["plain_ms"]["fire_encode_states_full"], None, nbytes(r, *out_c),
            OPS_PER_ELEM["fire_encode_full"] * r.numel(),
            chain_steps=(r.shape[0] // 8) * CHAIN_OPS["fire_encode_full"][eb],
            no_states_ms=time_ms(
                lambda: fc.fire_encode(r, eb, truncate_coeffs=False)))]

    for what, k in seek.items():
        table[what + " sidecar"] = seek_rows(what, k)
        log_rows(what + " sidecar", table[what + " sidecar"])
        for r_ in table[what + " sidecar"]:
            extra = {k_: r_[k_] for k_ in ("chunks", "serial_ms",
                                           "no_states_ms", "moved_ms")
                     if k_ in r_}
            log(f"[timing] {what} sidecar {r_['name']}: {json.dumps(extra)}")
    for what, f in ld_fire.items():
        table[what + " sidecar"] = fire_states_full_rows(f)
        log_rows(what + " sidecar", table[what + " sidecar"])
    # FIRE's transform instantiations at the 8 MiB walks (phase 3i's
    # inputs; the plain time is its one full-size run there, on the host's
    # CPU)
    for w, what in (("u8 walk 8 MiB", "u8 main (nb 16384, D 64)"),
                    ("u16 walk 8 MiB", "u16 main (nb 8192, D 64)")):
        f = xf_inputs[(w, 64)]
        eb, r, raw = f["eb"], f["rows"], f["raw"]
        nblocks, nv = r.shape[0] // 8, r.numel()
        out_v = fc.fire_decode(raw, eb, transform=True)
        table[what + " transform"] = [
            row("fire_encode_transform",
                lambda: fc.fire_encode(r, eb, transform=True),
                f["plain_ms"]["fire_encode_transform"], None, 2 * nbytes(r),
                OPS_PER_ELEM["fire_encode_transform"] * nv,
                chain_steps=nblocks * CHAIN_OPS["fire_encode_transform"][eb],
                plain_on="cpu"),
            row("fire_decode_transform",
                lambda: fc.fire_decode(raw, eb, transform=True),
                f["plain_ms"]["fire_decode_transform"], None,
                nbytes(raw, out_v), OPS_PER_ELEM["fire_decode_transform"] * nv,
                chain_steps=nblocks * CHAIN_OPS["fire_decode_transform"][eb],
                plain_on="cpu")]
        log_rows(what + " transform", table[what + " transform"])
    log("[timing] kernels " + json.dumps(table))

    class Split:
        """Named host-clock intervals; ``device`` ones end in a
        synchronize and record the kernels' share beside them."""

        def __init__(self):
            self.t = {}

        def host(self, key, fn):
            c = time.perf_counter()
            out = fn()
            self.t[key] = self.t.get(key, 0.0) + time.perf_counter() - c
            return out

        def sync(self, key, fn):
            torch.cuda.synchronize()
            return self.host(key, lambda: (fn(), torch.cuda.synchronize())[0])

        def device(self, key, fn):
            with KernelClock() as clock:
                out = self.sync(key, fn)
            self.t["kernels"] = self.t.get("kernels", 0.0) + clock.seconds()
            return out

    def split_decode(sp: Split, buf: bytes, elem_sz: int, codec: str):
        ng, _, nd = read_metadata_rle(buf)
        lowdim = nd <= LOWDIM_MAX_NDIMS[elem_sz]
        idx = sp.host("walk", lambda: decoder.walk_headers(
            buf, ng, nd, elem_sz, lowdim))
        dense = sp.host("gather", lambda: decoder.gather_payloads(buf, idx))
        up = sp.sync("h2d", lambda: decoder.upload_payload(dense, idx, dev))
        vals = sp.device("device", lambda: decoder.decode_device(
            *up, idx.total_rows, elem_sz, codec, lowdim))
        sp.host("d2h", lambda: decoder.download_values(vals))

    def split_encode(sp: Split, x: np.ndarray, codec: str) -> bytes:
        es, nd = x.dtype.itemsize, x.shape[1]
        lowdim = nd <= LOWDIM_MAX_NDIMS[es]
        rows = sp.sync("h2d", lambda: encoder.upload_rows(
            x, dev, narrow=lowdim and codec == "delta"))
        widths, hdr, dense, ws = sp.device(
            "device", lambda: encoder.encode_device(rows, es, codec, lowdim))
        w_np, h_np, d_np, ws_np = sp.host("d2h", lambda: (
            widths.to(torch.uint8).cpu().numpy(),
            hdr.to(torch.uint8).cpu().numpy(), dense.cpu().numpy(),
            ws.cpu().numpy()))
        plan = sp.host("plan", lambda: build_plan(
            ws_np == 0, x.size, nd, codec == "xff" and not lowdim))
        return sp.host("assemble", lambda: encoder.assemble_stream(
            plan, w_np, h_np, d_np, nd, es,
            x.reshape(-1)[x.size - plan.remaining_elems:], lowdim, ws_np))

    def split_huff_encode(sp: Split, stream: bytes):
        data = np.frombuffer(stream, np.uint8)
        cs = hf.auto_chunk_symbols(data.size)
        t = sp.host("huf table", lambda: hf.build_table(data))
        args = sp.sync("huf h2d", lambda: (hf.upload_bytes(data, dev),
                                           *hf.encode_table(t, dev)))
        payload, sizes = sp.device("huf device",
                                   lambda: hk.encode_chunks(*args, cs))
        p_b, s_np = sp.host("huf d2h", lambda: (
            payload.cpu().numpy().tobytes(),
            sizes.cpu().numpy().astype(np.uint32)))
        sp.host("huf head", lambda: hf._build_head(
            data.size, cs, s_np.size, t, s_np) + p_b)

    def split_huff_decode(sp: Split, buf: bytes) -> bytes:
        n, cs, _, t, sizes, offs = sp.host("huf parse", lambda: hf._parse(
            buf))
        args = sp.sync("huf h2d", lambda: (
            hf.upload_bytes(np.frombuffer(buf, np.uint8), dev),
            torch.from_numpy(offs).to(dev),
            torch.from_numpy(sizes.astype(np.int32)).to(dev),
            *hf.decode_tables(t, dev)))
        out = sp.device("huf device", lambda: hk.decode_chunks(
            *args, cs, n))
        return sp.host("huf d2h", lambda: out.cpu().numpy()[:n].tobytes())

    def med(fn, reps) -> dict:
        runs = [fn() for _ in range(reps)]
        return {k: statistics.median(r[k] for r in runs) for k in runs[0]}

    def e2e_of(case, reps=E2E_REPS) -> dict:
        x, buf = streams[case[0]], bufs[case]
        codec, entropy = case[1], case[2]
        es = x.dtype.itemsize

        def enc():
            c = time.perf_counter()
            codec_of(case).compress(x)
            return {"e2e": time.perf_counter() - c}

        def dec():
            c = time.perf_counter()
            codec_of(case).decompress(buf)
            return {"e2e": time.perf_counter() - c}

        def enc_split():
            sp = Split()
            stream = split_encode(sp, x, codec)
            if entropy == "huffman":
                split_huff_encode(sp, stream)
            return sp.t

        def dec_split():
            sp = Split()
            plain = buf
            if entropy == "huffman" and hf.is_container(buf):
                plain = split_huff_decode(sp, buf)
            split_decode(sp, plain, es, codec)
            return sp.t

        return {"bytes": x.nbytes, "compressed": len(buf),
                "encode_s": {**med(enc, reps), **med(enc_split, reps)},
                "decode_s": {**med(dec, reps), **med(dec_split, reps)}}

    e2e = {}
    ld_e2e = [(w, c, "none") for w in ("u8 d4 walk 4 MiB", "u16 d2 walk 4 MiB")
              for c in ("delta", "xff")]
    for case in cases + ld_e2e:
        key = " ".join(case)
        r = e2e[key] = e2e_of(case)
        for side in ("encode_s", "decode_s"):
            log(f"[e2e] {key} {side[:6]}: " + ", ".join(
                f"{k} {v * 1e3:.3f} ms ({r['bytes'] / v / 1e9:.4f} GB/s)"
                if v else f"{k} 0 ms" for k, v in r[side].items()))
    log("[e2e] " + json.dumps({"card": smi, "streams": e2e}))

    def split_decode_sidecar(sp: Split, buf: bytes, sc, elem_sz: int,
                             codec: str):
        """decompress_parallel's steps: the parallel walk, the gather, H2D,
        the chunked device pass, D2H."""
        ng, _, nd = read_metadata_rle(buf)
        lowdim = nd <= LOWDIM_MAX_NDIMS[elem_sz]
        ro = np.asarray(sc.row_offsets)
        idx = sp.host("walk", lambda: decoder.walk_headers_parallel(
            buf, ng, nd, elem_sz, sc.byte_offsets, ro, sc.every_groups,
            lowdim))
        dense = sp.host("gather", lambda: decoder.gather_payloads(buf, idx))
        up = sp.sync("h2d", lambda: decoder.upload_payload(dense, idx, dev))
        states = np.zeros((ro.size, 3, nd), np.int32)
        states[:, : sc.states.shape[1]] = sc.states
        vals = sp.device("device", lambda: decoder.decode_device(
            *up, idx.total_rows, elem_sz, codec, lowdim,
            chunks=(ro // 8, states)))
        sp.host("d2h", lambda: decoder.download_values(vals))

    def seek_e2e(case, reps=E2E_REPS) -> dict:
        """decompress with and without the sidecar, and compress_seekable
        beside compress, in turns (serial, sidecar, sidecar, serial) each
        round; then both decodes' splits."""
        x, buf, sc = streams[case[0]], sk_bufs[case], sidecars[case]
        cd, es, codec = codec_of(case), x.dtype.itemsize, case[1]
        t = {k: [] for k in ("decode", "decode_sidecar", "encode",
                             "encode_seekable")}

        def timed(key, fn):
            c = time.perf_counter()
            fn()
            t[key].append(time.perf_counter() - c)

        for _ in range(reps):
            for key in ("decode", "decode_sidecar", "decode_sidecar",
                        "decode"):
                timed(key, (lambda: cd.decompress(buf)) if key == "decode"
                      else (lambda: cd.decompress(buf, sidecar=sc)))
            for key in ("encode", "encode_seekable", "encode_seekable",
                        "encode"):
                timed(key, (lambda: cd.compress(x)) if key == "encode"
                      else (lambda: cd.compress_seekable(x)))

        def serial_split():
            sp = Split()
            split_decode(sp, buf, es, codec)
            return sp.t

        def sidecar_split():
            sp = Split()
            split_decode_sidecar(sp, buf, sc, es, codec)
            return sp.t

        return {"bytes": x.nbytes, "compressed": len(buf),
                "sidecar_bytes": len(sc.to_bytes()),
                "checkpoints": len(sc.byte_offsets),
                **{k + "_s": statistics.median(v) for k, v in t.items()},
                "decode_split_s": med(serial_split, reps),
                "decode_sidecar_split_s": med(sidecar_split, reps)}

    sk_e2e = {}
    for case in [(w, "xff", "none") for w in (
            "u8 walk 8 MiB", "u16 walk 8 MiB", "u8 walk 64 MiB",
            "u8 d4 walk 4 MiB", "u16 d2 walk 4 MiB")] + [
                ("u8 walk 8 MiB", "delta", "none")]:
        key = " ".join(case)
        r = sk_e2e[key] = seek_e2e(case)
        log(f"[e2e seekable] {key}: decode {r['decode_s'] * 1e3:.3f} ms, "
            f"with the sidecar {r['decode_sidecar_s'] * 1e3:.3f} ms; encode "
            f"{r['encode_s'] * 1e3:.3f} ms, compress_seekable "
            f"{r['encode_seekable_s'] * 1e3:.3f} ms; sidecar "
            f"{r['sidecar_bytes']} B ({r['checkpoints']} checkpoints) beside "
            f"{r['compressed']} B; splits ms: serial " + ", ".join(
                f"{k} {v * 1e3:.3f}" for k, v in r["decode_split_s"].items())
            + "; sidecar " + ", ".join(
                f"{k} {v * 1e3:.3f}" for k, v in
                r["decode_sidecar_split_s"].items()))
    log("[e2e seekable] " + json.dumps({"card": smi, "streams": sk_e2e}))

    # The batch's FIRE at S * D lanes: the encode over the xff-batch
    # shape's (256, 512 * 64) lanes, the decode's 512 chunks of 32 blocks
    # from the zero state, each beside its plain version (a loop over the
    # 32 blocks of a lane).
    t_phase = time.perf_counter()
    bx = batches["u8 512 x 256 x 64"]
    lanes = pk.widen_rows(encoder.upload_rows(
        bx.reshape(-1, 64), dev, narrow=True).reshape(512, 256, 64).permute(
        1, 0, 2).reshape(256, 512 * 64)).contiguous()
    b_errs = fc.fire_encode(lanes, 8).reshape(256, 512, 64).permute(
        1, 0, 2).reshape(-1, 64).to(torch.uint8).contiguous()
    b_first = np.arange(513, dtype=np.int64) * 32
    b_states = torch.zeros((512, 3, 64), dtype=torch.int32, device=dev)
    what = "batch u8 512 x 256 x 64 (S * D = 32768 lanes)"
    check("fire_encode", fc.fire_encode(lanes, 8),
          fc.fire_encode_plain(lanes, 8), what)
    check("fire_decode_short",
          fc.fire_decode_chunks(b_errs, 8, b_first, b_states),
          fc.fire_decode_chunks_plain(b_errs, 8, b_first, b_states), what)
    nv = lanes.numel()
    out_bd = fc.fire_decode_chunks(b_errs, 8, b_first, b_states)
    table[what] = [
        row("fire_encode", lambda: fc.fire_encode(lanes, 8),
            lambda: fc.fire_encode_plain(lanes, 8), None, 2 * nbytes(lanes),
            OPS_PER_ELEM["fire_encode"] * nv,
            chain_steps=32 * CHAIN_OPS["fire_encode"][8], lanes=512 * 64),
        row("fire_decode_short",
            lambda: fc.fire_decode_chunks(b_errs, 8, b_first, b_states),
            lambda: fc.fire_decode_chunks_plain(b_errs, 8, b_first,
                                                b_states), None,
            nbytes(b_errs, out_bd, b_states) + b_first.nbytes,
            OPS_PER_ELEM["fire_decode"] * nv,
            chain_steps=32 * CHAIN_OPS["fire_decode"][8], chunks=512)]
    log_rows(what, table[what])
    del lanes, b_errs, out_bd

    # The reduce on each query stream's values (the whole timeline, or the
    # data blocks with their gaps), each op, beside its plain version and
    # torch.sum / amax / amin (on u16 through an int16 view: torch has no
    # uint16 reduction kernels; the yardstick is the bytes, not the values)
    def library_reduce(vals, op):
        v = vals.view(torch.int16) if vals.dtype == torch.uint16 else vals
        if op == "sum":
            return lambda: torch.sum(v, dim=0, dtype=torch.int32)
        return (lambda: torch.amax(v, dim=0)) if op == "max" else (
            lambda: torch.amin(v, dim=0))

    reduce_json = None
    for case in q_cases:
        vals, gaps, lead = q_vals[case]
        what = f"query {case[0]} {case[1]} ({case[2]}) reduce"
        table[what] = []
        calls = [(op, None, False) for op in qk.OPS]
        if gaps is not None:
            calls.append(("sum", gaps, lead))
        for op, g, ld in calls:
            r_ = row("reduce_cols",
                     lambda: qk.reduce_cols(vals, op, g, ld),
                     lambda: qk.reduce_cols_plain(vals, op, g, ld),
                     library_reduce(vals, op),
                     nbytes(vals, g) + 4 * vals.shape[1], 2 * vals.numel(),
                     op=op + (" with gaps" if g is not None else ""))
            table[what].append(r_)
            if reduce_json is None:
                reduce_json = r_
        log_rows(what, table[what])
        log(f"[timing] {what} ops: "
            + ", ".join(f"{r_['op']} {r_['ms']:.4f} ms" for r_ in table[what]))

    def in_turns(fns: dict, rounds: int = 3) -> dict:
        """Median ms of each of two functions, timed in turns (a, b, b, a)
        ``rounds`` times, each a time_ms."""
        (ka, fa), (kb, fb) = fns.items()
        ms = {ka: [], kb: []}
        for _ in range(rounds):
            for k, f in ((ka, fa), (kb, fb), (kb, fb), (ka, fa)):
                ms[k].append(time_ms(f))
        return {k: statistics.median(v) for k, v in ms.items()}

    # The epilogue kernels at each delta query stream (the compact pass's
    # data blocks, the sum with the runs' gaps), each op, with and without
    # store, beside the plain K2 or lowdim decode followed by reduce_cols,
    # in turns; the unfused pair inside its launches too
    epi_json = {}
    for case, e in q_epi.items():
        what = f"query {case[0]} {case[1]} ({case[2]}) epilogue"
        table[what] = []
        args, g, lead = e["data blocks"]
        eb, nd = e["eb"], e["nd"]
        name = "decode_lowdim_reduce" if e["lowdim"] else "prefix_finish_reduce"
        kern = qk.decode_lowdim_reduce if e["lowdim"] else qk.prefix_finish_reduce
        plain = (qk.decode_lowdim_reduce_plain if e["lowdim"]
                 else qk.prefix_finish_reduce_plain)
        serial = ((lambda: dk.decode_delta_lowdim(*args, eb)) if e["lowdim"]
                  else (lambda: dk.prefix_finish(*args, eb)))
        v0 = serial()
        for op in qk.OPS:
            gg = g if op == "sum" else None
            for store in (False, True):
                def fused(op=op, gg=gg, store=store):
                    return kern(*args, eb, op, gg, lead, store)

                def unfused(op=op, gg=gg):
                    return qk.reduce_cols(serial(), op, gg, lead)

                pair = in_turns({"unfused_ms": unfused, "fused_ms": fused})
                r_ = row(name, fused,
                         lambda op=op, gg=gg, store=store: plain(
                             *args, eb, op, gg, lead, store), None,
                         nbytes(*args, gg) + (nbytes(v0) if store else 0)
                         + 4 * nd,
                         OPS_PER_ELEM[name] * v0.numel(),
                         op=op + (" with gaps" if gg is not None else ""),
                         store=store, **pair,
                         unfused_kernel_ms=launch_ms(unfused))
                table[what].append(r_)
                if op == "sum" and not store and case[0] in (
                        "u8 walk 8 MiB", "u8 d4 walk 4 MiB"):
                    epi_json[name] = r_
        log_rows(what, table[what])
        log(f"[timing] {what}: " + ", ".join(
            f"{r_['op']}{' store' if r_['store'] else ''} {r_['fused_ms']:.4f}"
            f" ms (inside {r_['kernel_ms']:.4f}) against the plain "
            f"kernel + reduce_cols {r_['unfused_ms']:.4f} ms (inside "
            f"{r_['unfused_kernel_ms']:.4f})" for r_ in table[what]))
    log("[timing] batch and query kernels " + json.dumps(
        {k: v for k, v in table.items() if k.startswith(("batch", "query"))}))

    def split_encode_batch(sp: Split, x: np.ndarray, codec: str):
        """compress_batch's steps: H2D, the device pass, D2H, the plans and
        assemblies of every stream (host)."""
        ns, nrows, nd = x.shape
        es = x.dtype.itemsize
        lowdim = nd <= LOWDIM_MAX_NDIMS[es]
        nr = nrows // 8 * 8
        t = sp.sync("h2d", lambda: encoder.upload_rows(
            x[:, :nr].reshape(-1, nd), dev, narrow=True))
        out = sp.device("device", lambda: encoder.encode_batch_device(
            t.reshape(ns, nr, nd), es, codec, lowdim))
        w_np, h_np, d_np, ws_np = sp.host("d2h", lambda: (
            out[0].to(torch.uint8).cpu().numpy(),
            out[1].to(torch.uint8).cpu().numpy(), out[2].cpu().numpy(),
            out[3].cpu().numpy()))

        def host():
            nb, n = nr // 8, nrows * nd
            for s in range(ns):
                blk = slice(s * nb, (s + 1) * nb)
                plan = build_plan(ws_np[blk] == 0, n, nd,
                                  codec == "xff" and not lowdim)
                encoder.assemble_stream(
                    plan, w_np[blk], h_np[blk], d_np[blk], nd, es,
                    x[s].reshape(-1)[n - plan.remaining_elems:], lowdim,
                    ws_np[blk])

        sp.host("host", host)

    def split_decode_batch(sp: Split, bb: list, es: int, codec: str):
        """decompress_batch's steps: the walks, the gather, H2D, the device
        pass, D2H, the split into streams with their tails (host)."""
        nd = read_metadata_rle(bb[0])[2]
        lowdim = nd <= LOWDIM_MAX_NDIMS[es]
        udt = np.uint8 if es == 1 else np.uint16

        def walks():
            out = []
            for i, b in enumerate(bb):
                ng, rem, _ = read_metadata_rle(b)
                idx = decoder.walk_headers(b, ng, nd, es, lowdim)
                out.append((i, idx, np.frombuffer(b, udt, rem,
                                                  idx.tail_offset)))
            return out

        batch = sp.host("walk", walks)
        dense, widths, out_rows, starts = sp.host(
            "gather", lambda: decoder.gather_batch(bb, batch, nd, es, lowdim))
        up = sp.sync("h2d", lambda: [torch.from_numpy(a).to(dev) for a in (
            dense, widths, out_rows)])
        vals = sp.device("device", lambda: decoder.decode_batch(
            *up, starts, es, codec, lowdim))
        flat = sp.host("d2h", lambda: decoder.download_values(vals))
        sp.host("split", lambda: [
            np.concatenate([flat[r * nd:(r + idx.total_rows) * nd], tail])
            for (_, idx, tail), r in zip(batch, starts)])

    def batch_e2e(case) -> dict:
        """compress_batch and decompress_batch (medians of BATCH_REPS) beside
        S single calls (one run, from the checks), and their splits."""
        x, bb = batches[case[0]], b_bufs[case]
        cd = SprintzCodec(case[1], x.dtype.itemsize, device="cuda")
        t = {"encode": [], "decode": []}
        for _ in range(BATCH_REPS):
            c = time.perf_counter()
            cd.compress_batch(list(x))
            t["encode"].append(time.perf_counter() - c)
            c = time.perf_counter()
            cd.decompress_batch(bb)
            t["decode"].append(time.perf_counter() - c)

        def enc_split():
            sp = Split()
            split_encode_batch(sp, x, case[1])
            return sp.t

        def dec_split():
            sp = Split()
            split_decode_batch(sp, bb, x.dtype.itemsize, case[1])
            return sp.t

        return {"streams": x.shape[0], "bytes": x.nbytes,
                "compressed": sum(map(len, bb)),
                "encode_batch_s": statistics.median(t["encode"]),
                "encode_single_s": b_single[case]["encode"],
                "decode_batch_s": statistics.median(t["decode"]),
                "decode_single_s": b_single[case]["decode"],
                "encode_split_s": med(enc_split, BATCH_REPS),
                "decode_split_s": med(dec_split, BATCH_REPS)}

    b_e2e = {}
    for case in b_cases:
        key = " ".join(case)
        r = b_e2e[key] = batch_e2e(case)
        log(f"[e2e batch] {key}: compress_batch {r['encode_batch_s'] * 1e3:.3f}"
            f" ms ({r['bytes'] / r['encode_batch_s'] / 1e9:.4f} GB/s) against "
            f"{r['streams']} single compress {r['encode_single_s'] * 1e3:.3f} "
            f"ms; decompress_batch {r['decode_batch_s'] * 1e3:.3f} ms ("
            f"{r['bytes'] / r['decode_batch_s'] / 1e9:.4f} GB/s) against "
            f"{r['decode_single_s'] * 1e3:.3f} ms; splits ms: encode "
            + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in
                        r["encode_split_s"].items())
            + "; decode " + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in
                                      r["decode_split_s"].items()))
    log("[e2e batch] " + json.dumps({"card": smi, "batches": b_e2e}))

    def query_e2e(case) -> dict:
        """query(sum, materialize=False) beside decompress + numpy's sum, in
        turns (decompress, query, query, decompress), medians."""
        x, buf = streams[case[0]], q_bufs[case]
        es, nd = x.dtype.itemsize, x.shape[1]
        cd = SprintzCodec(case[1], es, device="cuda")
        params = tquery.QueryParams(tquery.Operation.REDUCE_SUM, False)
        t = {"query": [], "decompress_numpy": []}
        for _ in range(E2E_REPS):
            for key in ("decompress_numpy", "query", "query",
                        "decompress_numpy"):
                c = time.perf_counter()
                if key == "query":
                    tquery.query(buf, params, case[1], es, device="cuda")
                else:
                    cd.decompress(buf).reshape(-1, nd).sum(axis=0,
                                                            dtype=np.int64)
                t[key].append(time.perf_counter() - c)
        return {"bytes": x.nbytes, "path": case[2],
                **{k + "_s": statistics.median(v) for k, v in t.items()}}

    q_e2e = {}
    for case in q_cases:
        key = " ".join(case)
        r = q_e2e[key] = query_e2e(case)
        log(f"[e2e query] {key}: query sum {r['query_s'] * 1e3:.3f} ms "
            f"({r['bytes'] / r['query_s'] / 1e9:.4f} GB/s), decompress + "
            f"numpy {r['decompress_numpy_s'] * 1e3:.3f} ms")
    log("[e2e query] " + json.dumps({"card": smi, "streams": q_e2e}))
    log(f"[timing] the batch and query rows took "
        f"{time.perf_counter() - t_phase:.1f} s")

    # The sharded paths beside the single-device ones, in turns (single,
    # sharded, sharded, single), the L2 flushed before each, with splits:
    # host (walk and gather, or the shards' rows), H2D, the device pass
    # (its collectives' copies inside it; kernels: inside the launches),
    # D2H (values; or header fields and the compact payload), and the
    # encode's plan and assembly.
    t_phase = time.perf_counter()

    def split_dp_decode(sp: Split, mesh, buf: bytes, es: int, c: str):
        job = sp.host("host", lambda: pshard.index_stream(mesh, buf, c, es))
        up = sp.sync("h2d", lambda: pshard.upload_stream(mesh, job))
        vals = sp.device("device", lambda: pshard.decode_shards(mesh, job, up))
        sp.host("d2h", lambda: pshard.download_values(mesh, vals, job))

    def split_dp_encode(sp: Split, mesh, x: np.ndarray, c: str):
        flat, nd, es = x.reshape(-1), x.shape[1], x.dtype.itemsize
        rows, nb_max = sp.host("host", lambda: pshard.shard_rows(
            flat, nd, mesh.size, list(range(mesh.size))))
        up = sp.sync("h2d", lambda: pshard.upload_shards(mesh, rows))
        enc = sp.device("device", lambda: pshard.encode_shards(mesh, up, es, c))
        got = sp.host("d2h", lambda: pshard.download_encoded(mesh, enc, es))
        return sp.host("assemble", lambda: pshard.assemble(
            *got, lambda r: flat[flat.size - r:], flat.size, nd, es, c,
            nb_max))

    def dist_e2e(w: str, c: str, n: int) -> dict:
        x, buf = streams[w], bufs[(w, c, "none")]
        es, nd = x.dtype.itemsize, x.shape[1]
        mesh = meshes[n]
        cd = SprintzCodec(c, es, device="cuda")
        rowmajor = nd > LOWDIM_MAX_NDIMS[es]
        fns = {"decompress": lambda: cd.decompress(buf),
               "dp_decompress": lambda: pshard.dp_decompress(mesh, buf, c, es)}
        if rowmajor:
            fns.update({"compress": lambda: cd.compress(x),
                        "dp_compress": lambda: pshard.dp_compress(
                            mesh, x.reshape(-1), nd, c)})
        t = {k: [] for k in fns}
        for _ in range(E2E_REPS):
            for pair in (("decompress", "dp_decompress"),
                         ("compress", "dp_compress")):
                if pair[0] not in fns:
                    continue
                for key in (pair[0], pair[1], pair[1], pair[0]):
                    flush.zero_()
                    torch.cuda.synchronize()
                    c0 = time.perf_counter()
                    fns[key]()
                    t[key].append(time.perf_counter() - c0)

        def dec_split():
            flush.zero_()
            sp = Split()
            split_dp_decode(sp, mesh, buf, es, c)
            return sp.t

        def enc_split():
            flush.zero_()
            sp = Split()
            if split_dp_encode(sp, mesh, x, c) != buf:
                raise AssertionError(f"dp_compress {w} {c}: bytes differ")
            return sp.t

        out = {"bytes": x.nbytes, **{k + "_s": statistics.median(v)
                                     for k, v in t.items()},
               "dp_decompress_split_s": med(dec_split, E2E_REPS)}
        if rowmajor:
            out["dp_compress_split_s"] = med(enc_split, E2E_REPS)
        return out

    d_e2e = {}
    for w, c in (("u8 walk 8 MiB", "delta"), ("u8 walk 8 MiB", "xff"),
                 ("u16 walk 8 MiB", "delta"), ("u8 runs 8 MiB", "delta"),
                 ("u8 d4 walk 4 MiB", "delta")):
        for n in (1, 4, 8):
            key = f"{w} {c} {n} shards"
            r = d_e2e[key] = dist_e2e(w, c, n)
            log(f"[e2e dist] {key}: " + ", ".join(
                f"{k[:-2]} {v * 1e3:.3f} ms" for k, v in r.items()
                if k.endswith("_s") and not isinstance(v, dict)) + "; "
                + "; ".join(f"{k[:-2]}: " + ", ".join(
                    f"{kk} {vv * 1e3:.3f} ms" for kk, vv in v.items())
                    for k, v in r.items() if isinstance(v, dict)))
    log("[e2e dist] " + json.dumps({"card": smi, "streams": d_e2e}))

    # FIRE's serial scans with their carries (init and final pointers, the
    # chain's launch) beside the scans without, in turns, at the 8 MiB
    # walks; the same instantiations, so this is the carries' own cost
    carry_t = {}
    for what in ("u8 main (nb 16384, D 64)", "u16 main (nb 8192, D 64)"):
        a = inputs[what]
        eb, r, fe = a["eb"], a["rows"], a["ferrs"]
        st = torch.zeros((3, r.shape[1]), dtype=torch.int32, device=dev)
        fns = {
            "encode": lambda: fc.fire_encode(r, eb),
            "encode_carries": lambda: fc.fire_encode(r, eb, init_state=st,
                                                     final=True),
            "decode": lambda: fc.fire_decode(fe, eb),
            "decode_carries": lambda: fc.fire_decode(fe, eb, st, final=True)}
        ms = {k: [] for k in fns}
        for _ in range(3):
            for k in ("encode", "encode_carries", "encode_carries", "encode",
                      "decode", "decode_carries", "decode_carries", "decode"):
                ms[k].append(time_ms(fns[k]))
        carry_t[what] = {k: statistics.median(v) for k, v in ms.items()}
        log(f"[timing] FIRE carries {what}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in carry_t[what].items()))
    log("[timing] FIRE carries " + json.dumps({"card": smi, **carry_t}))
    log(f"[timing] the distribution rows took "
        f"{time.perf_counter() - t_phase:.1f} s")

    # the other codec formats end to end: compress_simple beside compress
    # (raw beside delta) and decompress_simple beside decompress, then the
    # transforms beside delta's compress and decompress, in turns, the L2
    # flushed before each run; and the simple codecs' device passes beside
    # the RLE codec's (CUDA events, as the kernel rows)
    t_phase = time.perf_counter()

    def e2e_turns(fns: dict, pairs) -> dict:
        t = {k: [] for k in fns}
        for _ in range(E2E_REPS):
            for a_, b_ in pairs:
                for key in (a_, b_, b_, a_):
                    flush.zero_()
                    torch.cuda.synchronize()
                    c0 = time.perf_counter()
                    fns[key]()
                    t[key].append(time.perf_counter() - c0)
        return {k: statistics.median(v) for k, v in t.items()}

    def gbs(nb_, sec):
        return f"{sec * 1e3:.3f} ms ({nb_ / sec / 1e9:.4f} GB/s)"

    s_e2e, t_e2e = {}, {}
    for w in ("u8 walk 8 MiB", "u16 walk 8 MiB"):
        x = streams[w]
        es, flat = x.dtype.itemsize, x.reshape(-1)
        eb = 8 * es
        rows = encoder.upload_rows(x, dev)
        rbuf = bufs[(w, "delta", "none")]
        for c in simple.CODECS:
            rc = "delta" if c == "raw" else c
            cd = SprintzCodec(rc, es, device="cuda")
            buf, sbuf = bufs[(w, rc, "none")], simple_bufs[(w, c)]
            r = e2e_turns({
                "compress": lambda: cd.compress(x),
                "compress_simple": lambda: simple.compress_simple(flat, 64, c),
                "decompress": lambda: cd.decompress(buf),
                "decompress_simple": lambda: simple.decompress_simple(
                    sbuf, c, elem_sz=es)},
                (("compress", "compress_simple"),
                 ("decompress", "decompress_simple")))
            # the device passes: the simple encode's forecast and
            # encode_errors beside the RLE encode's encode_device; each
            # decode's kernels on its own stream's gathered payload
            fore = {"raw": lambda: rows,
                    "delta": lambda: fc.delta_encode(rows, eb),
                    "xff": lambda: fc.fire_encode(rows, eb)}[c]
            sidx = decoder.walk_headers(
                sbuf, flat.size // (16 * 64), 64, es,
                start=8 if c == "xff" else 6, runs=False)
            sd, sw, _ = decoder.upload_payload(
                decoder.gather_payloads(sbuf, sidx), sidx, dev)
            ridx = decoder.walk_headers(buf, read_metadata_rle(buf)[0], 64, es)
            rd, rw, ro = decoder.upload_payload(
                decoder.gather_payloads(buf, ridx), ridx, dev)
            sdec = {"raw": lambda: pk.unpack_rows(sd, sw, narrow=es == 1),
                    "delta": lambda: dk.decode_delta_contiguous(sd, sw, eb),
                    "xff": lambda: fc.fire_decode(decoder.fire_errors(
                        sd, sw, es, False), eb)}[c]
            r["device_s"] = {
                "encode_simple": time_ms(lambda: encoder.encode_errors(
                    fore(), es, False)) / 1e3,
                "encode": time_ms(lambda: encoder.encode_device(
                    rows, es, rc, False)) / 1e3,
                "decode_simple": time_ms(sdec) / 1e3,
                "decode": time_ms(lambda: decoder.decode_device(
                    rd, rw, ro, ridx.total_rows, es, rc, False)) / 1e3}
            r["bytes"], r["compressed"] = x.nbytes, len(sbuf)
            key = f"{w} {c}"
            s_e2e[key] = r
            log(f"[e2e simple] {key} (beside {rc}): " + ", ".join(
                f"{k} {gbs(x.nbytes, v)}" for k, v in r.items()
                if isinstance(v, float)) + "; device passes " + ", ".join(
                f"{k} {v * 1e3:.4f} ms" for k, v in r["device_s"].items()))
        cd = SprintzCodec("delta", es, device="cuda")
        for tk in transforms.KINDS:
            tb = transforms.transform_encode(flat, tk, ndims=64)
            r = e2e_turns({
                "compress": lambda: cd.compress(x),
                "transform_encode": lambda: transforms.transform_encode(
                    flat, tk, ndims=64),
                "decompress": lambda: cd.decompress(rbuf),
                "transform_decode": lambda: transforms.transform_decode(
                    tb, tk, es)},
                (("compress", "transform_encode"),
                 ("decompress", "transform_decode")))
            key = f"{w} {tk}"
            t_e2e[key] = {**r, "bytes": x.nbytes}
            log(f"[e2e transform] {key} (beside delta): " + ", ".join(
                f"{k} {gbs(x.nbytes, v)}" for k, v in r.items()))
    log("[e2e simple] " + json.dumps({"card": smi, "streams": s_e2e}))
    log("[e2e transform] " + json.dumps({"card": smi, "streams": t_e2e}))
    log(f"[timing] the formats' rows took {time.perf_counter() - t_phase:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "plain_on", "bound_ms", "bound_by",
            "library_ms", "chain_bound_ms")
    line = (table["u8 main (nb 16384, D 64)"] + table[huff_what]
            + [r for r in table["u8 d4 walk 4 MiB (nb 131072, D 4)"]
               if r["name"] in ("encode_lowdim", "encode_lowdim_errs",
                                "decode_lowdim", "unpack_lowdim_raw")]
            + table["u8 d4 walk 32k rows (nb 4096, D 4)"]
            + table["u8 main (nb 16384, D 64) sidecar"]
            + [r for r in table["u8 d4 walk 4 MiB (nb 131072, D 4) sidecar"]
               if r["name"] in ("fire_decode_short_full",
                                "fire_decode_chunks_full",
                                "decode_lowdim_chunks")]
            + table["u8 d4 walk 32k rows (nb 4096, D 4) sidecar"]
            + [reduce_json, epi_json["prefix_finish_reduce"],
               epi_json["decode_lowdim_reduce"]]
            + table["u8 main (nb 16384, D 64) transform"])
    assert sorted(r["name"] for r in line) == sorted(KERNELS)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in line]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
