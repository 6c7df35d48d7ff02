#!/usr/bin/env python3
"""Check the query's reduce kernels on the card and time them against an
earlier ``csrc`` (the standalone reduce with its memset, the decode without
the reduce epilogue), in turns on one card.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 sprintz_tpu_torch/probes/query_probe.py [--old DIR] [--variants]
        [--check-only]

1. Checks: ``reduce_cols`` at ``host_build.QUERY_CASES`` and K2's and the
   lowdim decode's reduce epilogue at ``host_build.EPILOGUE_CASES``, built
   with nvcc, against their plain versions (every op, store flag and gap
   setting), the kept accumulators zero after every launch; then the
   serial K1, K2 and lowdim decode (``REDUCE`` false) against theirs on
   the streams below.
2. With ``--old DIR`` (``DIR`` holds the earlier ``decode.cu`` and
   ``query.cu``, for example ``git archive ffa1ebb sprintz_tpu_torch/csrc |
   tar -x -C build/parent``, then ``build/parent/sprintz_tpu_torch/csrc``),
   on ``chip_smoke.py``'s delta query streams (the 8 MiB u8 walk, the
   8 MiB u8 runs stream, the 8 MiB u16 stream near 65535, the 4 MiB u8 d4
   walk) and the 8 MiB u8 walk's xff values, each time the median of
   ``--reps`` rounds of (old, new, new, old) CUDA-event timings, the L2
   flushed before each, outputs equal:
   - ``reduce_cols``, old (a memset, then the reduce) against new, each op,
     the sum also with the runs' gaps;
   - the serial K1, K2 and lowdim decode, old against new;
   - the compact pass's device work: old K1, K2, memset and reduce against
     K1 and the epilogue K2 without store, and with it; old lowdim decode,
     memset and reduce against the epilogue lowdim decode;
   - and the SASS (``cuobjdump -sass``) of the serial K1, K2 and lowdim
     decode instantiations, old against new, instruction by instruction.
3. With ``--variants``: ``VARIANTS`` of ``query.cu`` and ``decode.cu``
   (edits of the committed sources: ablations that take a step out, whose
   results are wrong and not checked, and other formulations, which must
   give the committed kernels' results), each timed in turns against the
   committed kernel at the 8 MiB u8 walk and the 4 MiB d4 walk: the
   reduce's sum with and without gaps, the epilogue alone (K2's, given
   K1's outputs, or the lowdim decode's) without store, beside the
   serial K2 or lowdim decode.

The last line is a JSON object of every time, with the card's name and
power limit. Not part of the port's path and not imported by it.
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

REDUCE_ATOMICS = """    if (OP == OP_SUM) {
      atomicAdd(acc + col0 + c, v);
    } else {
      atomicMax(acc + col0 + c, v);
    }
"""
REDUCE_PUBLISH = (
    "  publish(acc, out, tb.ndims, op, leading_gap, kMask, reinterpret_cast<unsigned*>(s_w));\n")
# the last CTA folds every CTA's partials (written with plain stores after
# the accumulators) in shared memory, in place of the atomics onto D words
PARTS_PUBLISH = """__device__ __forceinline__ void publish_parts(uint32_t* acc, uint32_t* out, int ndims, int op,
                                              int leading_gap, uint32_t mask, unsigned* s_w) {
  __syncthreads();
  const unsigned nctas = gridDim.x * gridDim.y;
  if (threadIdx.x == 0) {
    __threadfence();
    s_w[0] = atomicAdd(acc + ndims, 1u) == nctas - 1u;
  }
  __syncthreads();
  if (s_w[0]) {
    __threadfence();
    unsigned* s_fold = s_w + 1;  // s_w holds 8 words a column at least
    for (int d = threadIdx.x; d < ndims; d += blockDim.x) s_fold[d] = 0u;
    __syncthreads();
    const uint32_t* part = acc + ndims + 1;
    for (long long i = threadIdx.x; i < (long long)gridDim.x * ndims; i += blockDim.x) {
      const uint32_t v = __ldcg(part + i);
      if (op == OP_SUM) {
        atomicAdd(s_fold + i % ndims, v);
      } else {
        atomicMax(s_fold + i % ndims, v);
      }
    }
    __syncthreads();
    for (int d = threadIdx.x; d < ndims; d += blockDim.x) {
      out[d] = op == OP_MIN ? (leading_gap ? 0u : s_fold[d] ^ mask) : s_fold[d];
    }
    if (threadIdx.x == 0) acc[ndims] = 0u;
  }
}

// Fewer"""
K2_FOLD = """        if (ra.op == RED_SUM) {
          atomicAdd(ra.acc + d0 + j, v);
        } else {
          atomicMax(ra.acc + d0 + j, v);
        }
"""
K2_RUNTIME_OP = """        const uint32_t flip = ra.op == RED_MIN ? kMask : 0u;
        uint32_t rsum = 0, rmax = 0;
        for (int r0 = k * RUN_ROWS; r0 < r1; r0 += BLOCK_SZ) {
          const uint32_t w7 = ra.gap_after ? 1u + s_gap[r0 / BLOCK_SZ] : 1u;
#pragma unroll
          for (int r8 = 0; r8 < BLOCK_SZ; ++r8) {
            if (r0 + r8 < r1) {
              T* v = elem(r0 + r8, j);
              acc += (uint32_t)*v - kBias;
              const uint32_t x = acc & kMask;
              if (ra.store) *v = (T)x;
              rsum += r8 == BLOCK_SZ - 1 ? x * w7 : x;
              rmax = rmax > (x ^ flip) ? rmax : x ^ flip;
            }
          }
        }
        s_red[k * p.dc + j] = ra.op == RED_SUM ? rsum : rmax;
      } else {"""
# (source, name) -> (edits, checked): ablations are timed, not checked
VARIANTS = {
    ("query", "reduce without its atomics (ablation)"): (
        [(REDUCE_ATOMICS, "    (void)v;\n")], False),
    ("query", "reduce without its publish (ablation)"): (
        [(REDUCE_PUBLISH, "")], False),
    ("query", "reduce, per-CTA partials folded by the last CTA"): (
        [(REDUCE_ATOMICS, "    acc[tb.ndims + 1 + (long long)blockIdx.x * tb.ndims + col0 + c] = v;\n"),
         (REDUCE_PUBLISH, "  publish_parts(acc, out, tb.ndims, op, leading_gap, kMask, "
                          "reinterpret_cast<unsigned*>(s_w));\n"),
         ("// A table of", PARTS_PUBLISH.replace("// Fewer", "// A table of"))], True),
    ("query", "reduce without its loads (ablation)"): (
        [("  if (vc < tb.nvec) {\n    long long r = r_start;",
          "  if (tb.nvec < 0) {\n    long long r = r_start;")], False),
    ("query", "reduce, 4 vectors in flight a thread"): (
        [("constexpr int UNROLL = 8;", "constexpr int UNROLL = 4;")], True),
    ("query", "reduce, one CTA a SM"): (
        [("const long long wave = (long long)(per_sm > 0 ? per_sm : 1) * device_sms();",
          "const long long wave = device_sms();")], True),
    ("decode", "epilogue without its publish (ablation)"): (
        [("  if constexpr (REDUCE) reduce_publish<EB>(ra, ndims, s_red);\n", "")], False),
    ("decode", "epilogue without its atomics (ablation)"): (
        [(K2_FOLD, "        (void)v;\n")], False),
    ("decode", "epilogue, the op a runtime test in the loop"): (
        [(None, K2_RUNTIME_OP)], True),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=pathlib.Path,
                    help="the directory of the earlier decode.cu and query.cu")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from sprintz_tpu_torch import SprintzCodec, decoder
    from sprintz_tpu_torch.constants import LOWDIM_MAX_NDIMS
    from sprintz_tpu_torch.ops import _build
    from sprintz_tpu_torch.ops import decode_kernels as dk
    from sprintz_tpu_torch.ops import query_kernels as qk
    from sprintz_tpu_torch.probes import host_build as hb
    from sprintz_tpu_torch.stream_format import read_metadata_rle

    if not torch.cuda.is_available():
        print("query_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    _build.build()
    for stem in ("decode", "query"):
        log = _build._target(_build.CSRC / f"{stem}.cu").with_suffix(".log")
        print(f"[ptxas] {stem}.cu:\n" + "\n".join(
            ln for ln in log.read_text().splitlines()
            if "reduce" in ln or "Used" in ln), flush=True)

    # ------------------------------------------------------------ checks
    class CardKernels(hb.HostKernels):
        """host_build's calls of the C entry points, on the card's tensors
        and the nvcc-built libraries: garbage outputs, zeroed accumulators
        that must stay zeroed."""

        device = dev

        def __init__(self):
            self.torch = torch
            self.gen = torch.Generator(device=dev).manual_seed(1)
            lib = _build._libraries()

            class Entries:  # the entry points, on the current stream
                def __getattr__(_, name):
                    fn = getattr(lib[_build.SIGNATURES[name][0]], name)
                    return lambda *a: fn(*a[:-1],
                                         torch.cuda.current_stream().cuda_stream)

            self.so = Entries()

        def check(self, err: int):
            if err:
                raise RuntimeError(f"CUDA error {err}")

        def garbage(self, shape, dtype):
            n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
            raw = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                                generator=self.gen)
            return raw.view(dtype).reshape(shape)

    ck = CardKernels()
    bad = []
    for case in hb.QUERY_CASES:
        r = hb.check_query_case(ck, *case)
        if r:
            bad.append(("reduce", case, r))
    for case in hb.EPILOGUE_CASES:
        r = hb.check_epilogue_case(ck, *case)
        if r:
            bad.append(("epilogue", case, r))
    torch.cuda.synchronize()
    print(f"[check] reduce_cols at {len(hb.QUERY_CASES)} cases, the epilogue "
          f"at {len(hb.EPILOGUE_CASES)}: " + ("all equal their plain versions"
                                              if not bad else f"{bad}"),
          flush=True)
    if bad:
        return 1

    # ------------------------------------------------------------ streams
    rng = np.random.default_rng(cs.SEED)
    qrng = np.random.default_rng(cs.SEED + 13)
    streams = {
        "u8 walk 8 MiB": cs.walk_stream(rng, 1 << 17, 64, 1),
        "u8 runs 8 MiB": cs.runs_stream(rng, 1 << 17, 64),
        "u16 top 8 MiB": (65535 - np.cumsum(qrng.integers(0, 4, (1 << 16, 64)),
                                            axis=0) % 512).astype(np.uint16),
        "u8 d4 walk 4 MiB": cs.walk_stream(rng, 1 << 20, 4, 1)}
    inputs = {}
    for name, x in streams.items():
        es = x.dtype.itemsize
        buf = SprintzCodec("delta", es, device="cuda").compress(x)
        ng, _, nd = read_metadata_rle(buf)
        lowdim = nd <= LOWDIM_MAX_NDIMS[es]
        idx = decoder.walk_headers(buf, ng, nd, es, lowdim)
        dense, widths, _ = decoder.upload_payload(
            decoder.gather_payloads(buf, idx), idx, dev)
        gaps = torch.from_numpy((np.diff(idx.out_rows, append=idx.total_rows)
                                 - 8).astype(np.int32)).to(dev)
        inputs[name] = dict(es=es, eb=8 * es, nd=nd, lowdim=lowdim, dense=dense,
                            widths=widths, gaps=gaps,
                            lead=bool(idx.out_rows[0] > 0))
        a = inputs[name]
        if lowdim:
            a["vals"] = dk.decode_delta_lowdim(dense, widths, a["eb"])
            want = dk.decode_delta_lowdim_plain(dense, widths, a["eb"])
            if not torch.equal(a["vals"], want):
                raise AssertionError(f"{name}: the serial lowdim decode differs")
        else:
            a["bz"], a["toff"] = dk.unpack_zz(dense, widths, a["eb"])
            a["bz"] = a["bz"].reshape(-1, nd)
            a["vals"] = dk.prefix_finish(a["bz"], a["toff"], a["eb"])
            if not torch.equal(a["vals"], dk.decode_delta_contiguous(
                    dense, widths, a["eb"])) or not torch.equal(
                    a["vals"], dk.prefix_finish_plain(a["bz"], a["toff"], a["eb"])):
                raise AssertionError(f"{name}: the serial K1 and K2 differ")
    x = streams["u8 walk 8 MiB"]
    buf = SprintzCodec("xff", 1, device="cuda").compress(x)
    ng, _, nd = read_metadata_rle(buf)
    idx = decoder.walk_headers(buf, ng, nd, 1, False)
    up = decoder.upload_payload(decoder.gather_payloads(buf, idx), idx, dev)
    inputs["u8 walk 8 MiB xff"] = dict(
        es=1, eb=8, nd=nd, lowdim=False, gaps=None, lead=False,
        vals=decoder.decode_device(*up, idx.total_rows, 1, "xff", False))
    torch.cuda.synchronize()
    print("[check] the serial K1, K2 and lowdim decode equal their plain "
          "versions on the streams", flush=True)
    if args.check_only or (args.old is None and not args.variants):
        print(json.dumps({"card": smi, "checked": True}), flush=True)
        return 0

    # ------------------------------------------------------------ timings
    OUT.mkdir(parents=True, exist_ok=True)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, *a):
        err = fn(*a, stream)
        if err:
            raise RuntimeError(f"{fn.__name__}: CUDA error {err}")

    def build(stem: str, path: pathlib.Path, tag: str) -> ctypes.CDLL:
        so = OUT / f"{stem}_{tag}_query_probe.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(path)],
                       check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        return ctypes.CDLL(str(so))

    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)

    def once(fn) -> float:
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    def turns(old_fn, new_fn) -> dict:
        for f in (old_fn, new_fn):
            f()
        ms = {"old": [], "new": []}
        for _ in range(args.reps):
            for k, f in (("old", old_fn), ("new", new_fn), ("new", new_fn),
                         ("old", old_fn)):
                ms[k].append(once(f))
        return {k: statistics.median(v) for k, v in ms.items()}

    res = {"card": smi}
    if args.variants:
        res["variants"] = variants(args, inputs, build, call, turns, smi)
    if args.old is None:
        print(json.dumps(res), flush=True)
        return 0
    old = {stem: build(stem, args.old / f"{stem}.cu", "old") for stem in ("decode", "query")}
    res["sass"] = same_sass(OUT / "decode_old_query_probe.so",
                            _build._target(_build.CSRC / "decode.cu"))
    print("[sass] the serial kernels, old against new: " + json.dumps(res["sass"]), flush=True)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    old["query"].sprintz_reduce_cols.argtypes = [P, P, P, L, I, I, I, I, P]
    for name in ("sprintz_unpack_zz", "sprintz_prefix_finish", "sprintz_decode_lowdim"):
        getattr(old["decode"], name).argtypes = list(_build.SIGNATURES[name][1])
    for name, a in inputs.items():
        eb, nd, vals = a["eb"], a["nd"], a["vals"]
        rows = vals.shape[0]
        out_old = torch.empty(nd, dtype=torch.int32, device=dev)
        r = res[name] = {}

        def old_reduce(v, op, g, lead, out=out_old):
            call(old["query"].sprintz_reduce_cols, v.data_ptr(),
                 None if g is None else g.data_ptr(), out.data_ptr(), v.shape[0],
                 nd, eb, qk.OPS.index(op), int(lead))
            return out

        calls = [(op, None, False) for op in qk.OPS]
        if a["gaps"] is not None:
            calls.append(("sum", a["gaps"], a["lead"]))
        for op, g, lead in calls:
            key = "reduce_cols " + op + (" with gaps" if g is not None else "")
            if not torch.equal(old_reduce(vals, op, g, lead),
                               qk.reduce_cols(vals, op, g, lead)):
                raise AssertionError(f"{name} {key}: old and new differ")
            r[key] = turns(lambda: old_reduce(vals, op, g, lead),
                           lambda: qk.reduce_cols(vals, op, g, lead))
        if "dense" not in a:
            continue
        d, w, g, lead = a["dense"], a["widths"], a["gaps"], a["lead"]
        nb = d.shape[0]
        o_vals = torch.empty_like(vals)
        if a["lowdim"]:
            o_status = torch.zeros(-(-nb // dk.lowdim_span_blocks(eb, nd)) + 1,
                                   dtype=torch.int64, device=dev)

            def old_decode():
                call(old["decode"].sprintz_decode_lowdim, d.data_ptr(),
                     w.data_ptr(), o_vals.data_ptr(), o_status.data_ptr(), nb, nd,
                     eb, 0, None, 0, None)
                return o_vals

            old_decode()
            if not torch.equal(o_vals, vals):
                raise AssertionError(f"{name}: old lowdim decode differs")
            r["lowdim decode"] = turns(old_decode,
                                       lambda: dk.decode_delta_lowdim(d, w, eb))
        else:
            ntiles = -(-nb // dk.TILE_BLOCKS)
            o_bz = torch.empty_like(a["bz"])
            o_toff = torch.empty_like(a["toff"])
            o_status = torch.empty(ntiles * nd + 1, dtype=torch.int64, device=dev)

            def old_k1():
                call(old["decode"].sprintz_unpack_zz, d.data_ptr(), w.data_ptr(),
                     o_bz.data_ptr(), o_toff.data_ptr(), o_status.data_ptr(), nb, nd,
                     d.shape[2], eb, 0, None, 0, None)

            def old_k2():
                call(old["decode"].sprintz_prefix_finish, o_bz.data_ptr(),
                     o_toff.data_ptr(), o_vals.data_ptr(), rows, nd, eb, None, 0, None)
                return o_vals

            def old_decode():
                old_k1()
                return old_k2()

            old_decode()
            if not torch.equal(o_vals, vals):
                raise AssertionError(f"{name}: old K1 and K2 differ")
            r["K1"] = turns(old_k1, lambda: dk.unpack_zz(d, w, eb))
            r["K2"] = turns(old_k2, lambda: dk.prefix_finish(a["bz"], a["toff"], eb))
        for op, gg, ld in calls:
            key = "compact " + op + (" with gaps" if gg is not None else "")
            for store in (False, True):
                def new_fn(op=op, gg=gg, ld=ld, store=store):
                    return qk.decode_reduce(d, w, eb, op, gg, ld, store,
                                            a["lowdim"])

                def old_fn(op=op, gg=gg, ld=ld):
                    return old_reduce(old_decode(), op, gg, ld)

                got = new_fn()
                if not torch.equal(got[1], old_fn()) or (
                        store and not torch.equal(got[0], vals)):
                    raise AssertionError(f"{name} {key}: the epilogue differs")
                r[key + (" store" if store else "")] = turns(old_fn, new_fn)
        print(f"[timing] {name}: " + json.dumps(r), flush=True)
    print(json.dumps(res), flush=True)
    return 0


def same_sass(old_so: pathlib.Path, new_so: pathlib.Path) -> dict:
    """{kernel: "identical" or the count of differing instructions} for
    every instantiation of the old library's K1, K2 and lowdim decode,
    matched in the new one by its demangled name (the new K2's and lowdim
    decode's REDUCE flag false and its ReduceArgs parameter left out)."""
    import re
    import shutil

    from sprintz_tpu_torch.ops import _build

    tools = pathlib.Path(_build._nvcc()).parent
    cuobjdump = shutil.which("cuobjdump") or str(tools / "cuobjdump")
    filt = shutil.which("cu++filt") or str(tools / "cu++filt")

    def kernels(so: pathlib.Path, new: bool) -> dict:
        text = subprocess.run([cuobjdump, "-sass", str(so)], check=True,
                              capture_output=True, text=True).stdout
        out = {}
        for part in text.split("Function : ")[1:]:
            mangled, body = part.split("\n", 1)
            name = subprocess.run([filt, mangled.strip()], check=True, capture_output=True,
                                  text=True).stdout.strip()
            if not re.search(r"unpack_zz_kernel|prefix_finish_kernel|decode_lowdim_kernel", name):
                continue
            if new:  # cu++filt writes a bool template argument as (bool)0 or (bool)1
                if re.search(r"(prefix_finish|decode_lowdim)_kernel<[^>]*, \(bool\)1>", name):
                    continue  # a REDUCE instantiation: new
                name = re.sub(r"((?:prefix_finish|decode_lowdim)_kernel<[^>]*), \(bool\)0>",
                              r"\1>", name)
                name = re.sub(r", (?:<unnamed>|\(anonymous namespace\))::ReduceArgs\)", ")", name)
            out[name] = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", body)
        return out

    old, new = kernels(old_so, False), kernels(new_so, True)
    res = {}
    for name, ins in old.items():
        got = new.get(name)
        if got is None:
            res[name] = "missing"
        elif got == ins:
            res[name] = "identical"
        else:
            res[name] = (f"{sum(a != b for a, b in zip(ins, got)) + abs(len(ins) - len(got))} "
                         f"of {len(ins)} instructions differ")
    return res


def variants(args, inputs, build, call, turns, smi) -> dict:
    """Each of ``VARIANTS`` timed in turns against the committed kernel
    (see the module's docstring, item 3)."""
    import concurrent.futures

    import torch

    from sprintz_tpu_torch.ops import _build
    from sprintz_tpu_torch.ops import decode_kernels as dk
    from sprintz_tpu_torch.ops import query_kernels as qk

    def source(stem, edits):
        src = (_build.CSRC / f"{stem}.cu").read_text()
        for old, new in edits:
            if old is None:  # K2's fold loop, the committed one replaced
                a = src.index("        // a loop for each op and store flag")
                end = "\n      } else {"
                b = src.index(end + "\n        for (int kk", a)
                src = src[:a] + new + src[b + len(end):]
                continue
            assert src.count(old) == 1, old
            src = src.replace(old, new)
        return src

    paths = {}
    for i, ((stem, name), (edits, _)) in enumerate(VARIANTS.items()):
        path = OUT / f"variant_{i}_{stem}.cu"
        path.write_text(source(stem, edits))
        paths[stem, name] = path
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as ex:
        futs = {k: ex.submit(build, k[0], v, f"variant_{i}")
                for i, (k, v) in enumerate(paths.items())}
        libs = {k: f.result() for k, f in futs.items()}
    for (stem, _), lib in libs.items():
        for name, (s, argtypes) in _build.SIGNATURES.items():
            if s == stem:
                getattr(lib, name).argtypes = list(argtypes)
    dev = torch.device("cuda")
    out = {"card": smi}
    for sname in ("u8 walk 8 MiB", "u8 d4 walk 4 MiB"):
        a = inputs[sname]
        eb, nd, vals, g, lead = a["eb"], a["nd"], a["vals"], a["gaps"], a["lead"]
        red = torch.empty(nd, dtype=torch.int32, device=dev)
        # the accumulators, the count and room for 4096 CTAs' partials
        acc = torch.zeros(nd + 1 + 4096 * nd, dtype=torch.int32, device=dev)
        r = out[sname] = {}

        def reduce_with(lib, gaps):
            def fn():
                call(lib.sprintz_reduce_cols, vals.data_ptr(),
                     None if gaps is None else gaps.data_ptr(), red.data_ptr(),
                     vals.shape[0], nd, eb, 0, int(lead), acc.data_ptr())
                return red
            return fn

        def epilogue_with(lib):
            if a["lowdim"]:
                d, w = a["dense"], a["widths"]
                st = dk.lowdim_status(dev, -(-d.shape[0] // dk.lowdim_span_blocks(eb, nd)) + 1)

                def fn():
                    call(lib.sprintz_decode_lowdim_reduce, d.data_ptr(), w.data_ptr(), None,
                         st.data_ptr(), d.shape[0], nd, eb, 0, g.data_ptr(), int(lead), 0,
                         acc.data_ptr(), red.data_ptr())
                    return red
            else:
                def fn():
                    call(lib.sprintz_prefix_finish_reduce, a["bz"].data_ptr(),
                         a["toff"].data_ptr(), None, vals.shape[0], nd, eb, 0, g.data_ptr(),
                         int(lead), 0, acc.data_ptr(), red.data_ptr())
                    return red
            return fn

        lib_now = _build._libraries()
        serial = ((lambda: dk.decode_delta_lowdim(a["dense"], a["widths"], eb)) if a["lowdim"]
                  else (lambda: dk.prefix_finish(a["bz"], a["toff"], eb)))
        now = {"reduce sum": reduce_with(lib_now["query"], None),
               "reduce sum with gaps": reduce_with(lib_now["query"], g),
               "epilogue sum with gaps": epilogue_with(lib_now["decode"])}
        r["committed"] = {k: turns(serial, f) for k, f in now.items()}
        for (stem, name), lib in libs.items():
            fns = ({"reduce sum": reduce_with(lib, None),
                    "reduce sum with gaps": reduce_with(lib, g)} if stem == "query"
                   else {"epilogue sum with gaps": epilogue_with(lib)})
            times = {}
            for k, f in fns.items():
                if VARIANTS[stem, name][1]:
                    want = now[k]().clone()
                    if not torch.equal(f(), want):
                        raise AssertionError(f"{sname} variant {name!r} {k} differs")
                else:
                    acc.zero_()
                times[k] = turns(now[k], f)
                acc.zero_()  # an ablation leaves its accumulators set
            r[name] = times
        print(f"[variants] {sname}: " + json.dumps(r), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
