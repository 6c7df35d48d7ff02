#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sprintz_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

1. build: compile ``sprintz_tpu_torch/csrc/*.cu`` with nvcc for sm_90a into
   ``build/sprintz_tpu_torch/`` (set-up time);
2. kernels: every kernel (K1 unpack_zz, K4 unpack_rows, K2 prefix_finish,
   K3 pack_rows) against its plain PyTorch version on the card, bit-exact,
   at the main path's shapes and at a ragged shape;
3. main path: compress then decompress with device="cuda" on the 8 MiB u8
   and u16 random walks, the 8 MiB runs stream and a 64 MiB u8 walk, with
   every kernel's launch counter set to 0 before that run and read after
   it (K1, K2 and K3 must have launched; K4 is not on the delta path and
   is listed with its count, 0); card bytes equal CPU bytes on a 1 MiB
   stream; the reference-made vectors in tests/vectors decode and
   re-encode exactly;
4. timings: each kernel, its plain version and, where one exists, one
   PyTorch call of the same function, by CUDA events (median of 25 after
   warm-up, L2 flushed before each run); compress and decompress end to
   end, split into host, H2D, device pass, kernels (the part of the device
   pass inside the kernel launches) and D2H.

The last two lines of standard output are the card's name and power limit
followed by ``{"ok": true, "device": {...}}``; the line before them is
``{"kernels": [...]}`` with all four kernels. Data is made with numpy from
a fixed seed. Without
a CUDA device, or without the package beside this script, it exits non-zero
and prints no result.
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
# integer operations per output element, counted from the kernels' source
OPS_PER_ELEM = {"unpack_zz": 12, "unpack_rows": 9, "prefix_finish": 3,
                "pack_rows": 6}
KERNELS = {  # name -> (source, TPU kernel it replaces: pallas_call site)
    "unpack_zz": ("sprintz_tpu_torch/csrc/decode.cu",
                  "sprintz_tpu/ops/pallas_decode.py:99"),
    "prefix_finish": ("sprintz_tpu_torch/csrc/decode.cu",
                      "sprintz_tpu/ops/pallas_decode.py:171"),
    "pack_rows": ("sprintz_tpu_torch/csrc/pack.cu",
                  "sprintz_tpu/ops/pallas_pack.py:242"),
    "unpack_rows": ("sprintz_tpu_torch/csrc/decode.cu",
                    "sprintz_tpu/ops/pallas_pack.py:75"),
}
# K4 (unpack_rows, K1's raw mode) is ported, held to its plain version and
# timed here, but the delta path does not launch it: decode takes K1, which
# fuses the zigzag decode. Its first caller is FIRE decode. It is listed
# with the others, its launch count 0, and is exempt from the launch check.
OFF_PATH = ("unpack_rows",)


def log(msg: str) -> None:
    print(msg, flush=True)


def walk_stream(rng, nrows: int, ndims: int, elem_sz: int) -> np.ndarray:
    """bench.py's headline family: a random walk with steps in [-6, 6]."""
    hi = 1 << (8 * elem_sz)
    return (np.cumsum(rng.integers(-6, 7, (nrows, ndims)), axis=0) % hi
            ).astype(np.uint8 if elem_sz == 1 else np.uint16)


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
        from sprintz_tpu_torch import decoder, encoder
        from sprintz_tpu_torch.ops import _build
        from sprintz_tpu_torch.ops import decode_kernels as dk
        from sprintz_tpu_torch.ops import pack_kernels as pk
        from sprintz_tpu_torch.ops.bitmath import block_widths_rowmajor
        from sprintz_tpu_torch.models.forecasters import delta_encode
        from sprintz_tpu_torch.planner import build_plan
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
    wrappers = {"unpack_zz": dk.unpack_zz, "prefix_finish": dk.prefix_finish,
                "pack_rows": pk.pack_rows, "unpack_rows": pk.unpack_rows}

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
        """Device inputs of every kernel, from stream x as the path makes
        them: encode side (errs, widths) and decode side (dense with the
        real stream's MAXB, widths, biased deltas, tile offsets)."""
        eb = 8 * elem_sz
        nd = x.shape[1]
        rows = encoder.upload_rows(x, dev)
        blocks = delta_encode(rows, eb).reshape(-1, 8, nd)
        widths = block_widths_rowmajor(blocks.amax(dim=1), elem_sz)
        buf = encoder.compress(x.reshape(-1), nd, device=dev)
        ng, _, _ = read_metadata_rle(buf)
        idx = decoder.walk_headers(buf, ng, nd, elem_sz)
        dense, dwidths, _ = decoder.upload_payload(
            decoder.gather_payloads(buf, idx), idx, dev)
        bz, tots = dk.unpack_zz_plain(dense, dwidths, eb)
        return dict(blocks=blocks, widths=widths, dense=dense,
                    dwidths=dwidths, bz=bz.reshape(-1, nd),
                    toff=dk.exclusive_offsets(tots), eb=eb, es=elem_sz,
                    rows=rows)

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
        check("prefix_finish", dk.prefix_finish(a["bz"], a["toff"], eb),
              dk.prefix_finish_plain(a["bz"], a["toff"], eb), what)
        # the stream's data blocks: an odd last block goes to the verbatim
        # tail, since blocks are coded in groups of two
        vals = dk.decode_delta_contiguous(a["dense"], a["dwidths"], eb)
        torch.cuda.synchronize()
        if not np.array_equal(decoder.download_values(vals),
                              x[: vals.shape[0]].reshape(-1)):
            raise AssertionError(f"decode_delta_contiguous {what}: values "
                                 f"differ from the input")
        log(f"[kernels] {what}: MAXB {a['dense'].shape[2]}, all four "
            f"kernels equal their plain versions")

    # ------------------------------------------------------ 3. main path
    streams = {
        "u8 walk 8 MiB": walk_stream(rng, 1 << 17, 64, 1),
        "u16 walk 8 MiB": walk_stream(rng, 1 << 16, 64, 2),
        "u8 runs 8 MiB": runs_stream(rng, 1 << 17, 64),
        "u8 walk 64 MiB": walk_stream(rng, 1 << 20, 64, 1),
    }
    bufs = {}
    for w in wrappers.values():
        w.launches = 0
    for what, x in streams.items():
        buf = sprintz_tpu_torch.compress(x, device="cuda")
        out = sprintz_tpu_torch.decompress(buf, elem_sz=x.dtype.itemsize,
                                           device="cuda")
        if not np.array_equal(out, x.reshape(-1)):
            raise AssertionError(f"main path {what}: round trip differs")
        bufs[what] = buf
    launches = {k: w.launches for k, w in wrappers.items()}
    for what, x in streams.items():
        log(f"[main] {what}: {x.nbytes} B -> {len(bufs[what])} B "
            f"(ratio {x.nbytes / len(bufs[what]):.4f}), round trip exact")
    log(f"[main] launches: {json.dumps(launches)}")
    missing = [k for k, n in launches.items() if n == 0 and k not in OFF_PATH]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")

    x1 = walk_stream(rng, 1 << 14, 64, 1)  # 1 MiB
    b_gpu = sprintz_tpu_torch.compress(x1, device="cuda")
    b_cpu = sprintz_tpu_torch.compress(x1, device="cpu")
    if b_gpu != b_cpu:
        raise AssertionError("1 MiB stream: card bytes differ from CPU bytes")
    if not np.array_equal(
            sprintz_tpu_torch.decompress(b_cpu, device="cuda"),
            sprintz_tpu_torch.decompress(b_gpu, device="cpu")):
        raise AssertionError("1 MiB stream: card and CPU decode differ")
    log("[main] 1 MiB stream: card bytes == CPU bytes")

    vec = pathlib.Path(__file__).resolve().parent / "tests" / "vectors"
    for name, nd, es in (("delta_8b_d9_rand", 9, 1),
                         ("delta_16b_d17_sparse", 17, 2)):
        ref = (vec / f"{name}.sprintz").read_bytes()
        want = np.frombuffer((vec / f"{name}.in").read_bytes(),
                             dtype=np.uint8 if es == 1 else np.uint16)
        if not np.array_equal(
                sprintz_tpu_torch.decompress(ref, elem_sz=es, device="cuda"),
                want):
            raise AssertionError(f"vector {name}: decode differs")
        if encoder.compress(want, nd, device="cuda") != ref:
            raise AssertionError(f"vector {name}: re-encode differs")
    log("[main] reference vectors decode and re-encode exactly")

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

    def nbytes(*ts) -> int:
        return sum(t.numel() * t.element_size() for t in ts)

    def kernel_rows(a):
        eb, es = a["eb"], a["es"]
        # K2's function as one library call: the per-tile prefix of the
        # deltas (torch.cumsum has no uint16 kernel, so u16 goes as int16)
        bz_tiles = (a["bz"].view(torch.int16) if es == 2 else a["bz"]).view(
            -1, dk.TILE_ROWS, a["bz"].shape[1])
        out_k1 = dk.unpack_zz(a["dense"], a["dwidths"], eb)
        out_k3 = pk.pack_rows(a["blocks"], a["widths"], es)
        out_k4 = pk.unpack_rows(a["dense"], a["dwidths"])
        nvals = a["bz"].numel()
        spec = {
            "unpack_zz": (
                lambda: dk.unpack_zz(a["dense"], a["dwidths"], eb),
                lambda: dk.unpack_zz_plain(a["dense"], a["dwidths"], eb),
                None, nbytes(a["dense"], a["dwidths"], *out_k1)),
            "prefix_finish": (
                lambda: dk.prefix_finish(a["bz"], a["toff"], eb),
                lambda: dk.prefix_finish_plain(a["bz"], a["toff"], eb),
                lambda: torch.cumsum(bz_tiles, dim=1, dtype=torch.int32),
                nbytes(a["bz"], a["toff"], a["bz"])),
            "pack_rows": (
                lambda: pk.pack_rows(a["blocks"], a["widths"], es),
                lambda: pk.pack_rows_plain(a["blocks"], a["widths"], es),
                None, nbytes(a["blocks"], a["widths"], out_k3)),
            "unpack_rows": (
                lambda: pk.unpack_rows(a["dense"], a["dwidths"]),
                lambda: pk.unpack_rows_plain(a["dense"], a["dwidths"]),
                None, nbytes(a["dense"], a["dwidths"], out_k4)),
        }
        rows = []
        for name, (kern, plain, lib, nb_) in spec.items():
            t_bytes = nb_ / mem_rate
            t_ops = OPS_PER_ELEM[name] * nvals / CORE_OPS_PER_S
            rows.append({
                "name": name, "route": "cuda", "source": KERNELS[name][0],
                "replaces": KERNELS[name][1], "launches": launches[name],
                "max_abs_err": max_err[name], "ms": time_ms(kern),
                "plain_ms": time_ms(plain),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": time_ms(lib) if lib else None,
                "bytes": nb_})
        # K3's bound above is that of its interface, which takes i32
        # errors and widths; the packing itself needs only the narrow
        # errors, u8 widths and the payload it writes.
        k3 = next(r for r in rows if r["name"] == "pack_rows")
        k3["packing_bytes"] = (a["blocks"].numel() * es + a["widths"].numel()
                               + nbytes(out_k3))
        k3["packing_bound_ms"] = k3["packing_bytes"] / mem_rate * 1e3
        return rows

    table = {}
    for what in ("u8 main (nb 16384, D 64)", "u16 main (nb 8192, D 64)"):
        table[what] = kernel_rows(inputs[what])
        for r in table[what]:
            log(f"[timing] {what} {r['name']}: {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}, {r['bytes']} B), library "
                f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
                + (f", packing bound {r['packing_bound_ms']:.4f} ms "
                   f"({r['packing_bytes']} B)" if "packing_bytes" in r
                   else ""))
    log("[timing] kernels " + json.dumps(table))

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

    def split_decode(buf: bytes, elem_sz: int) -> dict:
        t = {}
        c = time.perf_counter()
        ng, _, nd = read_metadata_rle(buf)
        idx = decoder.walk_headers(buf, ng, nd, elem_sz)
        t["walk"] = time.perf_counter() - c
        c = time.perf_counter()
        dense = decoder.gather_payloads(buf, idx)
        t["gather"] = time.perf_counter() - c
        torch.cuda.synchronize()
        c = time.perf_counter()
        up = decoder.upload_payload(dense, idx, dev)
        torch.cuda.synchronize()
        t["h2d"] = time.perf_counter() - c
        c = time.perf_counter()
        with KernelClock() as clock:
            vals = decoder.decode_device(*up, idx.total_rows, elem_sz)
            torch.cuda.synchronize()
        t["device"] = time.perf_counter() - c
        t["kernels"] = clock.seconds()
        c = time.perf_counter()
        decoder.download_values(vals)
        t["d2h"] = time.perf_counter() - c
        return t

    def split_encode(x: np.ndarray) -> dict:
        t = {}
        es, nd = x.dtype.itemsize, x.shape[1]
        torch.cuda.synchronize()
        c = time.perf_counter()
        rows = encoder.upload_rows(x, dev)
        torch.cuda.synchronize()
        t["h2d"] = time.perf_counter() - c
        c = time.perf_counter()
        with KernelClock() as clock:
            widths, hdr, dense, ws = encoder.encode_device(rows, es)
            torch.cuda.synchronize()
        t["device"] = time.perf_counter() - c
        t["kernels"] = clock.seconds()
        c = time.perf_counter()
        w_np = widths.to(torch.uint8).cpu().numpy()
        h_np = hdr.to(torch.uint8).cpu().numpy()
        d_np = dense.cpu().numpy()
        z = ws.cpu().numpy() == 0
        t["d2h"] = time.perf_counter() - c
        c = time.perf_counter()
        plan = build_plan(z, x.size, nd)
        t["plan"] = time.perf_counter() - c
        c = time.perf_counter()
        encoder.assemble_stream(plan, w_np, h_np, d_np, nd, es, x[:0, 0])
        t["assemble"] = time.perf_counter() - c
        return t

    def med(fn, reps) -> dict:
        runs = [fn() for _ in range(reps)]
        return {k: statistics.median(r[k] for r in runs) for k in runs[0]}

    e2e = {}
    for what, x in streams.items():
        reps = 1 if x.nbytes > (8 << 20) else E2E_REPS
        es = x.dtype.itemsize

        def enc():
            c = time.perf_counter()
            sprintz_tpu_torch.compress(x, device="cuda")
            return {"e2e": time.perf_counter() - c}

        def dec():
            c = time.perf_counter()
            sprintz_tpu_torch.decompress(bufs[what], elem_sz=es, device="cuda")
            return {"e2e": time.perf_counter() - c}

        row = {"bytes": x.nbytes, "compressed": len(bufs[what]),
               "encode_s": {**med(enc, reps), **med(lambda: split_encode(x),
                                                    reps)},
               "decode_s": {**med(dec, reps), **med(
                   lambda: split_decode(bufs[what], es), reps)}}
        for side in ("encode_s", "decode_s"):
            log(f"[e2e] {what} {side[:6]}: " + ", ".join(
                f"{k} {v * 1e3:.3f} ms ({x.nbytes / v / 1e9:.4f} GB/s)"
                if v else f"{k} 0 ms" for k, v in row[side].items()))
        e2e[what] = row
    log("[e2e] " + json.dumps({"card": smi, "streams": e2e}))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = table["u8 main (nb 16384, D 64)"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
