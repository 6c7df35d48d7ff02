#!/usr/bin/env python3
"""Time the encode side's two hand kernels, K3 ``pack_rows`` and the
Huffman encoder, against an earlier version of their sources on the same
card, in one process.

Run from the root of a checkout on a machine with a CUDA card and nvcc,
with the earlier ``csrc`` directory unpacked somewhere, e.g.:

    git archive 2a5892d sprintz_tpu_torch/csrc | tar -x -C build/parent
    python3 sprintz_tpu_torch/probes/encode_ab.py \\
        --old build/parent/sprintz_tpu_torch/csrc

It builds the earlier ``pack.cu`` and ``huffman.cu`` (whose C entry points
take no tile argument, and whose encoder reads the payload's size back
between its passes) into ``build/sprintz_tpu_torch/probes/``, and calls
them through copies of their earlier wrappers. At the main path's shapes
(the 8 MiB u8 and u16 random walks and the 64 MiB u8 walk for K3; the
headline's sprintz stream at chunk size 128, the smooth stream's at 4096
and the 64 MiB walk's at 128 for the encoder) it checks that both
versions equal the plain one, then times them in turns (earlier, current,
current, earlier): CUDA events around the wrapper and around each of its
kernel launches, median of 25 after warm-up, the L2 flushed before each by
writing 1 GiB, as ``chip_smoke.py`` does. Beside them: the encoder up to
its read of the payload's size, and the cumsum between its passes alone.
``--variants`` adds builds of the current sources with parts changed (see
VARIANTS), timed the same way. ``--flushes`` times K3 again after a
read-only flush, which leaves the L2 no dirty lines to write back, with
a library copy of the errors (``Tensor.copy_``, each byte read and written
once) after each flush as a yardstick of the card's memory rate. The last
line is a JSON object of every time.

Not part of the port's path and not imported by it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
OUT = ROOT / "build" / "sprintz_tpu_torch" / "probes"
REPS = 25
# Variants of the current sources: (source stem, [(text, replacement)],
# the tile in elements (K3) or symbols (encoder), None for the wrapper's).
VARIANTS = {
    # K3 without its atomics: each run is ORed in by a plain
    # read-modify-write (wrong output; only the time is read)
    "pack, plain OR for atomicOr": ("pack", [
        ("if (w0) atomicOr(stage + word, w0);", "if (w0) stage[word] |= w0;"),
        ("if (w1) atomicOr(stage + word + 1, w1);",
         "if (w1) stage[word + 1] |= w1;"),
        ("if (w2) atomicOr(stage + word + 2, w2);",
         "if (w2) stage[word + 2] |= w2;"),
        ("if ((uint32_t)lo) atomicOr(stage + word, (uint32_t)lo);",
         "stage[word] |= (uint32_t)lo;"),
        ("if ((uint32_t)(lo >> 32)) atomicOr(stage + word + 1, "
         "(uint32_t)(lo >> 32));", "stage[word + 1] |= (uint32_t)(lo >> 32);")],
        None),
    # K3's CTAs and tiles: threads, errors a tile, loads a thread in flight
    "pack, 256 threads": ("pack", [
        ("constexpr int PACK_THREADS = 128;", "constexpr int PACK_THREADS = 256;")],
        None),
    "pack, 8 loads": ("pack", [
        ("constexpr int PACK_LOADS = 4;", "constexpr int PACK_LOADS = 8;")], None),
    "pack, 64 threads, 2048-element tiles": ("pack", [
        ("constexpr int PACK_THREADS = 128;", "constexpr int PACK_THREADS = 64;")],
        2048),
    # the encoder: its table's copies (bank conflicts of the lookups), and
    # its CTAs and tiles
    "huffman, 8 table copies": ("huffman", [
        ("constexpr int TAB_COPIES = 1;", "constexpr int TAB_COPIES = 8;")], None),
    "huffman, 32 table copies": ("huffman", [
        ("constexpr int TAB_COPIES = 1;", "constexpr int TAB_COPIES = 32;")],
        None),
    "huffman, 128 threads, 2048-symbol tiles": ("huffman", [
        ("constexpr int ENC_THREADS = 256;", "constexpr int ENC_THREADS = 128;")],
        2048),
    "huffman, 256 threads, 8192-symbol tiles": ("huffman", [], 8192),
}


def slug(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=pathlib.Path,
                    help="the earlier csrc directory")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--flushes", action="store_true",
                    help="also time under a read-only flush of the L2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("encode_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sprintz_tpu_torch import SprintzCodec, encoder
    from sprintz_tpu_torch.entropy import huffman as hf
    from sprintz_tpu_torch.models.forecasters import delta_encode
    from sprintz_tpu_torch.ops import _build
    from sprintz_tpu_torch.ops import huffman_kernels as hk
    from sprintz_tpu_torch.ops import pack_kernels as pk
    from sprintz_tpu_torch.ops.bitmath import block_widths_rowmajor

    dev = torch.device("cuda")
    OUT.mkdir(parents=True, exist_ok=True)
    srcs = {"old_pack": args.old / "pack.cu",
            "old_huffman": args.old / "huffman.cu"}
    if args.variants:
        for name, (stem, edits, _) in VARIANTS.items():
            src = (_build.CSRC / f"{stem}.cu").read_text()
            for old, new in edits:
                assert src.count(old) == 1, (name, old)
                src = src.replace(old, new)
            path = OUT / f"var_{slug(name)}.cu"
            path.write_text(src)
            srcs[name] = path
    procs = {k: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{slug(k)}.so"),
         str(p)], stdout=subprocess.DEVNULL) for k, p in srcs.items()}
    _build.build()
    failed = [k for k, p in procs.items() if p.wait()]
    if failed:
        raise RuntimeError(f"nvcc failed: {failed}")
    libs = {k: ctypes.CDLL(str(OUT / f"{slug(k)}.so")) for k in srcs}
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs["old_pack"].sprintz_pack_rows.argtypes = [P, P, P, L, I, I, P]
    libs["old_huffman"].sprintz_huff_encode_sizes.argtypes = [P, P, P, L, I, P]
    libs["old_huffman"].sprintz_huff_encode_emit.argtypes = [
        P, P, P, P, P, L, I, P]
    for k in srcs:
        if k.startswith("pack"):
            libs[k].sprintz_pack_rows.argtypes = [P, P, P, L, I, I, I, P]
        if k.startswith("huffman"):
            libs[k].sprintz_huff_encode_sizes.argtypes = [P, P, P, L, I, I, P]
            libs[k].sprintz_huff_encode_emit.argtypes = [
                P, P, P, P, P, P, L, I, I, P]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    events = []  # (start, end) CUDA events around each launch of a timed call
    per_launch = [[]]  # the last time_ms's median of each launch

    def call(fn, *a):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        err = fn(*a, torch.cuda.current_stream().cuda_stream)
        e.record()
        events.append((s, e))
        if err:
            raise RuntimeError(f"CUDA error {err}")

    launch = _build.launch

    def timed_launch(name, like, *a):
        stem, _ = _build.SIGNATURES[name]
        call(getattr(_build._libraries()[stem], name), *a)

    _build.launch = timed_launch

    def old_pack(errs, widths, es):
        nb, _, nd = errs.shape
        out = torch.empty((nb, 8, nd * es), dtype=torch.uint8, device=dev)
        call(libs["old_pack"].sprintz_pack_rows, errs.data_ptr(),
             widths.data_ptr(), out.data_ptr(), nb, nd, es)
        return out

    def pack_variant(lib, tile_elems):
        def fn(errs, widths, es):
            nb, _, nd = errs.shape
            out = torch.empty((nb, 8, nd * es), dtype=torch.uint8, device=dev)
            tile = (pk.pack_tile_rows(nd, es) if tile_elems is None
                    else max(16, tile_elems // nd // 16 * 16))
            call(lib.sprintz_pack_rows, errs.data_ptr(), widths.data_ptr(),
                 out.data_ptr(), nb, nd, es, tile)
            return out
        return fn

    def encode_variant(lib, tile_syms):
        def fn(syms, codes, lengths, cs):
            n = syms.shape[0]
            nchunks = -(-n // cs)
            tile = max(1, (tile_syms or hk.ENC_TILE_SYMBOLS) // cs)
            sizes = torch.empty(nchunks, dtype=torch.int32, device=dev)
            call(lib.sprintz_huff_encode_sizes, syms.data_ptr(),
                 lengths.data_ptr(), sizes.data_ptr(), n, cs, tile)
            ends = torch.cumsum(sizes, dim=0, dtype=torch.int64)
            payload = torch.empty(-(-hk.MAX_CODE_LEN * n // 8) + nchunks,
                                  dtype=torch.uint8, device=dev)
            call(lib.sprintz_huff_encode_emit, syms.data_ptr(),
                 codes.data_ptr(), lengths.data_ptr(), ends.data_ptr(),
                 sizes.data_ptr(), payload.data_ptr(), n, cs, tile)
            return payload[:int(ends[-1])], sizes
        return fn

    def old_encode(syms, codes, lengths, cs):
        lib = libs["old_huffman"]
        n = syms.shape[0]
        sizes = torch.empty(-(-n // cs), dtype=torch.int32, device=dev)
        call(lib.sprintz_huff_encode_sizes, syms.data_ptr(),
             lengths.data_ptr(), sizes.data_ptr(), n, cs)
        starts = torch.cumsum(sizes, dim=0, dtype=torch.int64) - sizes
        payload = torch.empty(int(starts[-1] + sizes[-1]), dtype=torch.uint8,
                              device=dev)
        call(lib.sprintz_huff_encode_emit, syms.data_ptr(), codes.data_ptr(),
             lengths.data_ptr(), starts.data_ptr(), payload.data_ptr(), n, cs)
        return payload, sizes

    def encode_no_read(syms, codes, lengths, cs):
        """encode_chunks up to its read of the payload's size: the payload
        at its bound."""
        n = syms.shape[0]
        nchunks, tile = -(-n // cs), hk.huff_tile_chunks(cs)
        sizes = torch.empty(nchunks, dtype=torch.int32, device=dev)
        _build.launch("sprintz_huff_encode_sizes", syms, syms.data_ptr(),
                      lengths.data_ptr(), sizes.data_ptr(), n, cs, tile)
        ends = torch.cumsum(sizes, dim=0, dtype=torch.int64)
        payload = torch.empty(-(-hk.MAX_CODE_LEN * n // 8) + nchunks,
                              dtype=torch.uint8, device=dev)
        _build.launch("sprintz_huff_encode_emit", syms, syms.data_ptr(),
                      codes.data_ptr(), lengths.data_ptr(), ends.data_ptr(),
                      sizes.data_ptr(), payload.data_ptr(), n, cs, tile)
        return payload, sizes

    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    flushes = {  # how the L2 is emptied before each timed call
        "write": flush.zero_,  # leaves 50 MB of dirty lines to write back
        "read": lambda: flush.max(),  # leaves clean lines
    }

    def time_ms(fn, how="write") -> tuple[float, float]:
        """(wrapper ms, ms inside its launches), medians of REPS."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        whole, inside, each = [], [], []
        for _ in range(REPS):
            flushes[how]()
            events.clear()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            whole.append(s.elapsed_time(e))
            each.append([a.elapsed_time(b) for a, b in events])
            inside.append(sum(each[-1]))
        per_launch[0] = [statistics.median(x) for x in zip(*each)]
        return statistics.median(whole), statistics.median(inside)

    def same(what, *outs):
        torch.cuda.synchronize()
        for o in outs[1:]:
            for a, b in zip(outs[0] if isinstance(outs[0], tuple) else [outs[0]],
                            o if isinstance(o, tuple) else [o]):
                if a.shape != b.shape or not torch.equal(a, b):
                    raise AssertionError(f"{what}: versions differ")

    def ab(what, fns: dict, how="write") -> dict:
        """Time fns in turns: each in order, then each in reverse order."""
        runs = {k: [] for k in fns}
        launches = {}
        for k in list(fns) + list(fns)[::-1]:
            runs[k].append(time_ms(fns[k], how))
            launches[k] = per_launch[0]
        res = {k: [statistics.mean(x[i] for x in v) for i in (0, 1)]
               for k, v in runs.items()}
        for k, (ms, kms) in res.items():
            print(f"[ab] {what} {k}, {how} flush: {ms:.4f} ms (inside its "
                  f"launches {kms:.4f} ms: "
                  + ", ".join(f"{t:.4f}" for t in launches[k]) + ")",
                  flush=True)
        return res

    rng = np.random.default_rng(0)
    walk = {  # name -> (nrows, elem_sz)
        "u8 walk 8 MiB": (1 << 17, 1), "u16 walk 8 MiB": (1 << 16, 2),
        "u8 walk 64 MiB": (1 << 20, 1)}
    result = {"card": smi}
    streams = {}
    for what, (nrows, es) in walk.items():
        x = (np.cumsum(rng.integers(-6, 7, (nrows, 64)), axis=0) % (1 << 8 * es)
             ).astype(np.uint8 if es == 1 else np.uint16)
        streams[what] = x
        rows = encoder.upload_rows(x, dev)
        blocks = delta_encode(rows, 8 * es).reshape(-1, 8, 64)
        widths = block_widths_rowmajor(blocks.amax(dim=1), es)
        fns = {"earlier": lambda: old_pack(blocks, widths, es),
               "current": lambda: pk.pack_rows(blocks, widths, es)}
        for k in srcs:
            if k.startswith("pack"):
                fns[k] = (lambda f: lambda: f(blocks, widths, es))(
                    pack_variant(libs[k], VARIANTS[k][2]))
        same(f"K3 {what}", pk.pack_rows_plain(blocks, widths, es),
             fns["earlier"](), fns["current"]())
        result[f"pack_rows {what}"] = ab(f"pack_rows {what}", fns)
        if args.flushes:
            # the same under a read-only flush, and a library copy of the
            # errors (read and write once) as a yardstick of the DRAM rate
            copy = torch.empty_like(blocks)
            fns["copy of the errors"] = lambda: copy.copy_(blocks)
            result[f"pack_rows {what}, read flush"] = ab(
                f"pack_rows {what}", fns, "read")
            for how in flushes:
                ms, _ = time_ms(fns["copy of the errors"], how)
                gbs = 2 * blocks.numel() * 4 / ms / 1e6
                result[f"copy {what}, {how} flush"] = [ms, gbs]
                print(f"[ab] copy of the errors {what}, {how} flush: "
                      f"{ms:.4f} ms, {gbs:.1f} GB/s", flush=True)
        del rows, blocks, widths

    smooth = (np.cumsum(rng.integers(-2, 3, (1 << 17, 64)), axis=0) % 256
              ).astype(np.uint8)
    for what, x in (("u8 walk 8 MiB", streams["u8 walk 8 MiB"]),
                    ("u8 smooth 8 MiB", smooth),
                    ("u8 walk 64 MiB", streams["u8 walk 64 MiB"])):
        inner = np.frombuffer(SprintzCodec("delta", 1, device="cuda").compress(
            x), np.uint8)
        cs = hf.auto_chunk_symbols(inner.size)
        enc = (hf.upload_bytes(inner, dev),
               *hf.encode_table(hf.build_table(inner), dev), cs)
        key = f"huff_encode {what} sprintz stream ({inner.size} B, cs {cs})"
        same(key, hk.encode_chunks_plain(*enc), old_encode(*enc),
             hk.encode_chunks(*enc))
        got, want = encode_no_read(*enc), hk.encode_chunks(*enc)
        same(key + ", no read", want, (got[0][:want[0].numel()], got[1]))
        fns = {"earlier": lambda: old_encode(*enc),
               "current": lambda: hk.encode_chunks(*enc),
               "current, no read of the total": lambda: encode_no_read(*enc)}
        for k in srcs:
            if k.startswith("huffman"):
                f = encode_variant(libs[k], VARIANTS[k][2])
                same(f"{key} {k}", fns["current"](), f(*enc))
                fns[k] = (lambda f: lambda: f(*enc))(f)
        sizes = fns["current"]()[1]
        ms, _ = time_ms(lambda: torch.cumsum(sizes, dim=0, dtype=torch.int64))
        print(f"[ab] {key}: the cumsum of the sizes alone {ms:.4f} ms",
              flush=True)
        result[key] = ab(key, fns)
        if args.flushes:
            result[key + ", read flush"] = ab(key, fns, "read")
    _build.launch = launch
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
