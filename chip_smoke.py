#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sprintz_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

1. build: compile ``sprintz_tpu_torch/csrc/*.cu`` with nvcc for sm_90a into
   ``build/sprintz_tpu_torch/``, one nvcc per source, all at once (set-up
   time);
2. kernels: every kernel against its plain PyTorch version on the card,
   bit-exact: K1 unpack_zz, K4 unpack_rows, K5 (K4's narrow mode), K2
   prefix_finish and K3 pack_rows at the main path's shapes and at a
   ragged shape; FIRE encode and decode (csrc/fire.cu, decode also from
   a carried state) over the whole main-path streams, u8 and u16 at D 64
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
   only 12-bit codes, one symbol value);
3. main path: compress then decompress with device="cuda", every kernel's
   launch counter set to 0 before that run and read after it (every kernel
   must have launched): delta on the 8 MiB u8 and u16 random walks, the
   8 MiB runs stream and a 64 MiB u8 walk; FIRE (xff) on the 8 MiB u8 and
   u16 walks and the runs stream; +Huf with delta and with xff on the 8 MiB
   u8 walk, a smooth 8 MiB stream (steps in [-2, 2], where Huffman must
   win) and the 64 MiB u8 walk. After that run, K6 and huff_encode are
   held to their plain versions on each +Huf case's own sprintz stream at
   the chunk size the path used. Card bytes equal CPU bytes on a 1 MiB
   stream for delta, xff and xff+Huf; the reference-made vectors in
   tests/vectors decode and re-encode exactly;
4. timings: each kernel's wrapper, the time inside its kernel launches
   alone, its plain version and, where one exists, one PyTorch call of the
   same function, by CUDA events (median of 25 after warm-up, L2 flushed
   before each run; the plain FIRE is its one full-size run of phase 2,
   at the same size as the kernel's time), at the 8 MiB walks; also K3
   on the 64 MiB u8 walk, and K6 and huff_encode at chunk size 4096 on
   the smooth 8 MiB stream's sprintz stream, whose plain decode (a Python
   loop of 4096 steps) is timed once. The FIRE rows also carry a
   chain bound: blocks x the dependent integer operations of a block,
   counted in csrc/fire.cu's header, x the latency of one dependent
   multiply-add, which a one-warp probe kernel measures on the card
   beside the SM clock. Then compress and
   decompress end to end, split into host, H2D, device pass, kernels (the
   part of the device pass inside the kernel launches) and D2H, for delta,
   xff and +Huf.

The last two lines of standard output are the card's name and power limit
followed by ``{"ok": true, "device": {...}}``; the line before them is
``{"kernels": [...]}`` with every kernel. Data is made with numpy from a
fixed seed. Without a CUDA device, or without the package beside this
script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
REPS = 25
E2E_REPS = 3
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
                "fire_decode": 15, "huff_decode": 30, "huff_encode": 12}
# FIRE's serial chain: dependent integer operations a block, by elem_bits
# (the count is in csrc/fire.cu's header), and its tiling
CHAIN_OPS = {"fire_encode": {8: 15, 16: 14}, "fire_decode": {8: 16, 16: 20}}
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
}
HUFF_CS = 128  # bench.py's chunk size for the Huffman kernel rows


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
        from sprintz_tpu_torch import SprintzCodec, decoder, encoder
        from sprintz_tpu_torch.entropy import huffman as hf
        from sprintz_tpu_torch.models import forecasters as fc
        from sprintz_tpu_torch.ops import _build
        from sprintz_tpu_torch.ops import decode_kernels as dk
        from sprintz_tpu_torch.ops import huffman_kernels as hk
        from sprintz_tpu_torch.ops import pack_kernels as pk
        from sprintz_tpu_torch.ops.bitmath import block_widths_rowmajor
        from sprintz_tpu_torch.planner import build_plan
        from sprintz_tpu_torch.probes import encode_cases as ec
        from sprintz_tpu_torch.stream_format import read_metadata_rle
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
    }
    assert set(counters) == set(KERNELS)

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s: "
        + ", ".join(p.name for p in libs.values()))
    for p in libs.values():
        ptxas = p.with_suffix(".log")
        if ptxas.exists():
            print(ptxas.read_text(), file=sys.stderr)

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
        bz, tots = dk.unpack_zz_plain(dense, dwidths, eb)
        ferrs = fc.fire_encode(rows, eb)
        return dict(blocks=blocks, widths=widths, dense=dense,
                    dwidths=dwidths, bz=bz.reshape(-1, nd),
                    toff=dk.exclusive_offsets(tots), eb=eb, es=elem_sz,
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
        r, fe = a["rows"], a["ferrs"]
        want_e, ms_e = once_ms(lambda: fc.fire_encode_plain(r, eb))
        check("fire_encode", fc.fire_encode(r, eb), want_e, what)
        want_d, ms_d = once_ms(lambda: fc.fire_decode_plain(fe, eb))
        check("fire_decode", fc.fire_decode(fe, eb), want_d, what)
        half = 1 << (eb - 1)  # a carried state: a value, a delta, a counter
        state = torch.stack([r[1], ((r[1] - r[0] + half) & (2 * half - 1))
                             - half, r[2] * 37]).contiguous()
        check("fire_decode", fc.fire_decode(fe, eb, state),
              fc.fire_decode_plain(fe, eb, state), what + ", a carried state")
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

    def check_fire(what, vals, eb, state=None, errs=None):
        """FIRE encode (from the zero state) and decode (from the zero state
        and from `state`) against their plain versions on the (N, D) int32
        values `vals`; `errs`: the errors to decode, else the encoder's."""
        t = torch.from_numpy(vals).to(dev)
        got = fc.fire_encode(t, eb)
        check("fire_encode", got, fc.fire_encode_plain(t, eb), what)
        zz = got if errs is None else errs
        zz = zz.to(torch.uint8) if eb == 8 else zz
        for st in (None, state):
            check("fire_decode", fc.fire_decode(zz, eb, st),
                  fc.fire_decode_plain(zz, eb, st), what)
        return fc.fire_decode(zz, eb, state)

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

    def huff_inputs(data: np.ndarray, cs: int):
        """Device inputs of both Huffman kernels for the bytes ``data``: the
        container coded at chunk size cs, as huff_decompress uploads it, and
        the symbols and code tables, as huff_compress uploads them."""
        buf = hf.huff_compress(data, chunk_symbols=cs, allow_stored=False,
                               device=dev)
        n, cs, nchunks, t, sizes, offsets = hf._parse(buf)
        dec = (hf.upload_bytes(np.frombuffer(buf, np.uint8), dev),
               torch.from_numpy(offsets).to(dev),
               torch.from_numpy(sizes.astype(np.int32)).to(dev),
               *hf.decode_tables(t, dev), cs, n)
        enc = (hf.upload_bytes(data, dev), *hf.encode_table(t, dev), cs)
        return dict(buf=buf, dec=dec, enc=enc, n=n, nchunks=nchunks,
                    payload=len(buf) - int(offsets[0]))

    def check_huff(what: str, data: np.ndarray, cs: int) -> dict:
        """K6 and the encoder against their plain versions on the bytes
        ``data`` coded at chunk size cs; K6's symbols equal the data."""
        h = huff_inputs(data, cs)
        syms = hk.decode_chunks(*h["dec"])
        check("huff_decode", syms, hk.decode_chunks_plain(*h["dec"]), what)
        if not np.array_equal(syms.cpu().numpy(), data):
            raise AssertionError(f"huff_decode {what}: symbols differ from "
                                 f"the data")
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
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    for case in cases:
        x = streams[case[0]]
        buf = codec_of(case).compress(x)
        if not np.array_equal(codec_of(case).decompress(buf), x.reshape(-1)):
            raise AssertionError(f"main path {case}: round trip differs")
        bufs[case] = buf
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
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
    missing = [k for k, n in launches.items() if n == 0]
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

    vec = here / "tests" / "vectors"
    for name, codec, nd, es in (("delta_8b_d9_rand", "delta", 9, 1),
                                ("delta_16b_d17_sparse", "delta", 17, 2),
                                ("xff_8b_d16_sparse", "xff", 16, 1),
                                ("xff_16b_d8_rand", "xff", 8, 2)):
        ref = (vec / f"{name}.sprintz").read_bytes()
        want = np.frombuffer((vec / f"{name}.in").read_bytes(),
                             dtype=np.uint8 if es == 1 else np.uint16)
        if not np.array_equal(sprintz_tpu_torch.decompress(
                ref, codec=codec, elem_sz=es, device="cuda"), want):
            raise AssertionError(f"vector {name}: decode differs")
        if encoder.compress(want, nd, codec=codec, device="cuda") != ref:
            raise AssertionError(f"vector {name}: re-encode differs")
    log("[main] reference vectors decode and re-encode exactly")

    # -------------------------------------------------------- 4. timings
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)

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
        taken (FIRE's, from its one full-size run in the kernel checks).
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
            "bound_ms": bounds[by] * 1e3, "bound_by": by,
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
        # the tables, and writes one byte per symbol; the encoder reads the
        # symbols and the tables, and writes the sizes and the payload
        # (its offsets are a cumsum between its two passes)
        dec_bytes = h["payload"] + nbytes(*dec[1:6]) + n
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
            lib = r["library_ms"]
            log(f"[timing] {what} {r['name']}: {r['ms']:.4f} ms (inside "
                f"its launches {r['kernel_ms']:.4f} ms), plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
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
    # the Huffman rows at the headline's chunk size, and at 4096 on the
    # smooth stream's sprintz stream (whose plain decode takes 4096 Python
    # steps a call: timed once)
    huff_what = next(iter(huff))
    table[huff_what] = huff_rows(huff[huff_what])
    log_rows(huff_what, table[huff_what])
    table[huff_smooth[0]] = huff_rows(huff_smooth[1], plain_dec_once=True)
    log_rows(huff_smooth[0], table[huff_smooth[0]])
    # K3 on the 64 MiB walk, whose i32 errors outgrow the 50 MB L2
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
    log_rows(what, table[what])
    del rows64, b64, w64
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
        idx = sp.host("walk", lambda: decoder.walk_headers(buf, ng, nd,
                                                           elem_sz))
        dense = sp.host("gather", lambda: decoder.gather_payloads(buf, idx))
        up = sp.sync("h2d", lambda: decoder.upload_payload(dense, idx, dev))
        vals = sp.device("device", lambda: decoder.decode_device(
            *up, idx.total_rows, elem_sz, codec))
        sp.host("d2h", lambda: decoder.download_values(vals))

    def split_encode(sp: Split, x: np.ndarray, codec: str) -> bytes:
        es, nd = x.dtype.itemsize, x.shape[1]
        rows = sp.sync("h2d", lambda: encoder.upload_rows(x, dev))
        widths, hdr, dense, ws = sp.device(
            "device", lambda: encoder.encode_device(rows, es, codec))
        w_np, h_np, d_np, z = sp.host("d2h", lambda: (
            widths.to(torch.uint8).cpu().numpy(),
            hdr.to(torch.uint8).cpu().numpy(), dense.cpu().numpy(),
            ws.cpu().numpy() == 0))
        plan = sp.host("plan", lambda: build_plan(z, x.size, nd,
                                                  codec == "xff"))
        return sp.host("assemble", lambda: encoder.assemble_stream(
            plan, w_np, h_np, d_np, nd, es, x[:0, 0]))

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
        syms = sp.device("huf device", lambda: hk.decode_chunks(
            *args, cs, n))
        return sp.host("huf d2h", lambda: syms.cpu().numpy().tobytes())

    def med(fn, reps) -> dict:
        runs = [fn() for _ in range(reps)]
        return {k: statistics.median(r[k] for r in runs) for k in runs[0]}

    def e2e_of(case) -> dict:
        x, buf = streams[case[0]], bufs[case]
        codec, entropy = case[1], case[2]
        es = x.dtype.itemsize
        reps = 1 if x.nbytes > (8 << 20) else E2E_REPS

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
    for case in cases:
        key = " ".join(case)
        r = e2e[key] = e2e_of(case)
        for side in ("encode_s", "decode_s"):
            log(f"[e2e] {key} {side[:6]}: " + ", ".join(
                f"{k} {v * 1e3:.3f} ms ({r['bytes'] / v / 1e9:.4f} GB/s)"
                if v else f"{k} 0 ms" for k, v in r[side].items()))
    log("[e2e] " + json.dumps({"card": smi, "streams": e2e}))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "chain_bound_ms")
    line = table["u8 main (nb 16384, D 64)"] + table[huff_what]
    assert sorted(r["name"] for r in line) == sorted(KERNELS)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in line]}),
          flush=True)
    print(smi, flush=True)
    # one card drove the run, however many the machine has
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
