#!/usr/bin/env python3
"""Time K6 (``csrc/huffman.cu``'s ``huff_decode_kernel``) on the card, with
its phases counted, beside a variant without its peek table and, with
``--old DIR``, an earlier K6.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 sprintz_tpu_torch/probes/decode_probe.py [--old DIR]

``DIR`` holds an earlier ``huffman.cu`` (``git archive <commit>
sprintz_tpu_torch/csrc | tar -x -C DIR`` puts it at
``DIR/sprintz_tpu_torch/csrc/huffman.cu``) whose ``sprintz_huff_decode``
takes (data, offsets, sizes, limits, adj, perm, out, nchunks, cs, n,
stream), the earlier one-thread-a-chunk K6.

It codes two containers as ``chip_smoke.py``'s kernel rows do: the 8 MiB
u8 random walk's sprintz stream at chunk size 128 and the smooth 8 MiB
stream's at 4096. It copies ``huffman.cu``, changes it by exact text
replacement (an assert fails when the source no longer has the text) and
builds one library a variant into ``build/sprintz_tpu_torch/probes/``:

- "as committed";
- "no table": each code's symbol and length computed from the canonical
  tables (held in global memory, read through L1) instead of the 4096-entry
  peek table, whose build is dropped;
- "counters": ``clock64`` counters that CTA thread 0 adds up over every
  window: the map of chunks to segments, the payload's load, the
  speculative decode, the rounds until no exit moves (and their number),
  the placement and the store; with the symbols of the speculative pass;
- "async stage": the payload's load issued as ``cp.async`` copies before
  the map of chunks to segments, so that the two overlap;
- ``SHAPES``: other segment lengths, CTA sizes (segments a window), least
  symbols a CTA and warm-up lengths.

Before the variants it prints, for each container, the share of
speculative 512-bit segment starts that have not found a true code
boundary after warm-ups of 0-512 bits (on the host).

Each variant is held to the committed one's output, then timed in turns
with the others (CUDA events around the C call, median of 25 after
warm-up, the L2 flushed by a 1 GiB write before each).

Not part of the port's path and not imported by it.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import statistics
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
SOURCE = HERE.parent / "csrc" / "huffman.cu"
OUT = ROOT / "build" / "sprintz_tpu_torch" / "probes"
NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
REPS = 25
# counter slots: cycles of the phases, then counts
PHASES = ("map", "load", "speculative decode", "rounds", "place", "store")
N_ROUNDS, N_WINDOWS, N_SYMS, N_SEGS = 6, 7, 8, 9


# other segment bits, threads (segments a window), least symbols a CTA
# and warm-up bits
SHAPES = {"seg 128 x256": (128, 256, 4096), "seg 256 x256": (256, 256, 4096),
          "seg 512 x64 tile 2048": (512, 64, 2048),
          "seg 1024 x128 tile 8192": (1024, 128, 8192),
          "warm 0": (None, None, None, 0), "warm 64": (None, None, None, 64),
          "warm 256": (None, None, None, 256)}


def sized(src: str, seg=None, threads=None, tile=None, warm=None) -> str:
    """The source with other segment, window, tile or warm-up sizes."""
    for name, value in (("DEC_SEG_BITS", seg), ("DEC_THREADS", threads),
                        ("DEC_TILE_SYMBOLS", tile), ("DEC_WARM_BITS", warm)):
        if value is not None:
            line = next(ln for ln in src.splitlines()
                        if ln.startswith(f"constexpr int {name} = "))
            src = replace(src, line, f"constexpr int {name} = {value};")
    return src


def replace(src: str, old: str, new: str, count: int = 1) -> str:
    assert src.count(old) == count, (old, src.count(old))
    return src.replace(old, new)


def untabled(src: str) -> str:
    """Each code decoded from the canonical tables, no peek table."""
    src = replace(src, "// Word k of the staged payload", """\
__device__ int32_t k6_lim[MAX_CODE_LEN - 1], k6_adj[MAX_CODE_LEN + 1], k6_perm[256];
__device__ __forceinline__ uint32_t k6_direct(uint32_t peek) {
  const int v = (int)(__brev(peek) >> 20);
  int len = 1;
#pragma unroll
  for (int l = 0; l < MAX_CODE_LEN - 1; ++l) len += v >= __ldg(k6_lim + l);
  int idx = (v >> (MAX_CODE_LEN - len)) + __ldg(k6_adj + len);
  idx = idx < 0 ? 0 : (idx > 255 ? 255 : idx);
  return (uint32_t)(__ldg(k6_perm + idx) & 0xFF) | ((uint32_t)len << 8);
}

// Word k of the staged payload""")
    src = replace(src, "const uint32_t e = tab[buf & 0xFFFu];",
                  "const uint32_t e = k6_direct((uint32_t)buf & 0xFFFu);")
    src = replace(src, "for (int e = t; e < (1 << MAX_CODE_LEN); e += DEC_THREADS) {",
                  "for (int e = t; e < 0; e += DEC_THREADS) {")
    return replace(src, 'extern "C" {\n', '''extern "C" {
int k6_set_tables(const void* lim, const void* adj, const void* perm) {
  cudaError_t e = cudaMemcpyToSymbol(k6_lim, lim, 4 * (MAX_CODE_LEN - 1), 0,
                                     cudaMemcpyDeviceToDevice);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(k6_adj, adj, 4 * (MAX_CODE_LEN + 1), 0,
                                               cudaMemcpyDeviceToDevice);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(k6_perm, perm, 4 * 256, 0,
                                               cudaMemcpyDeviceToDevice);
  return (int)e;
}
''')


def async_stage(src: str) -> str:
    """The payload's load issued as cp.async copies before the map."""
    src = replace(src, "// Word k of the staged payload", """\
// Copies 4 bytes from global to shared memory without a register, to be
// waited for by async_wait_all.
__device__ __forceinline__ void async_copy4(uint32_t* dst, const uint8_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void async_commit() { asm volatile("cp.async.commit_group;\\n" ::); }
__device__ __forceinline__ void async_wait_all() { asm volatile("cp.async.wait_all;\\n" ::); }

// Word k of the staged payload""")
    # state: where the next window's payload begins
    src = replace(src, "  int64_t next_chunk, next_slot, carry_exit, o_end;",
                  "  int64_t next_chunk, next_slot, next_lo, carry_exit, o_end;")
    src = replace(src, """  int carry_cnt = 0;      // the chunk's symbols before it, where cur_slot > 0
  while (cur < c_end) {
""", """  int carry_cnt = 0;      // the chunk's symbols before it, where cur_slot > 0
  // the window's first payload byte, and the CTA's last (reads stop there)
  int64_t lo = cur < c_end ? offsets[cur] : 0;
  const int64_t cta_hi = cur < c_end ? offsets[c_end - 1] + sizes[c_end - 1] : 0;
  while (cur < c_end) {
    // (c) stage the window's payload, in flight while (a) runs: 4-byte
    // asynchronous copies where inside the container, bytes elsewhere,
    // zeros past its end
    const int64_t lo16 = lo & ~(int64_t)15;
    {
      const int64_t hi = cta_hi < nbytes ? cta_hi : nbytes;
      const bool aligned = (reinterpret_cast<uintptr_t>(data) & 3) == 0;
      for (int u = t; u < DEC_STAGE_UNITS; u += DEC_THREADS) {
        const int64_t a = lo16 + 16LL * u;
        uint32_t* dst = sh.stage + stage_slot(4 * u);
        if (aligned && a + 16 <= hi) {
#pragma unroll
          for (int b = 0; b < 4; ++b) async_copy4(dst + b, data + a + 4 * b);
        } else {
          for (int b = 0; b < 4; ++b) {
            uint32_t w = 0;
            for (int i = 0; i < 4; ++i) {
              const int64_t x = a + 4 * b + i;
              if (x < nbytes && x < hi) w |= (uint32_t)__ldg(data + x) << (8 * i);
            }
            dst[b] = w;
          }
        }
      }
      async_commit();
    }
""")
    src = replace(src, """      sh.next_chunk = c;
      sh.next_slot = (t == 0 ? cur_slot : 0) + (DEC_WINDOW - sbeg);
""", """      sh.next_chunk = c;
      sh.next_slot = (t == 0 ? cur_slot : 0) + (DEC_WINDOW - sbeg);
      sh.next_lo = off + sh.next_slot * (DEC_SEG_BITS / 8);
""")
    src = replace(src, """      sh.next_chunk = c + 1;  // the window ends with this chunk
      sh.next_slot = 0;
""", """      sh.next_chunk = c + 1;  // the window ends with this chunk
      sh.next_slot = 0;
      sh.next_lo = off + size;
""")
    src = replace(src, """sh.nwin_chunks = t + 1;
    __syncthreads();
""", """sh.nwin_chunks = t + 1;
    async_wait_all();
    __syncthreads();
""")
    a = src.index("    // (c) stage the window's payload: 16-byte loads where aligned and")
    b = src.index("    // (d) decode each segment from its start")
    src = src[:a] + src[b:]
    src = replace(src, """    const int64_t nchunk = sh.next_chunk, nslot = sh.next_slot;
""", """    const int64_t nchunk = sh.next_chunk, nslot = sh.next_slot;
    lo = sh.next_lo;
""")
    return src


def counted(src: str) -> str:
    """clock64 counters of CTA thread 0, added over all windows and CTAs."""
    src = replace(src, "// Word k of the staged payload", """\
__device__ unsigned long long k6_dbg[16];
#define K6_PHASE(i) if (t == 0) { const long long now_ = clock64(); \\
    atomicAdd(k6_dbg + (i), (unsigned long long)(now_ - mark_)); mark_ = now_; }

// Word k of the staged payload""")
    src = replace(src, "  while (cur < c_end) {\n",
                  "  long long mark_ = clock64();\n  while (cur < c_end) {\n"
                  "    if (t == 0) atomicAdd(k6_dbg + 7, 1ull);\n")
    src = replace(src, "    const int nseg_w = ntot < DEC_WINDOW ? ntot : DEC_WINDOW;\n",
                  "    const int nseg_w = ntot < DEC_WINDOW ? ntot : DEC_WINDOW;\n"
                  "    K6_PHASE(0)\n")
    src = replace(src, "    __syncthreads();\n\n    // (d)",
                  "    __syncthreads();\n    K6_PHASE(1)\n\n    // (d)")
    src = replace(src, "    sh.seg_exit[k] = ex;\n    __syncthreads();\n",
                  "    sh.seg_exit[k] = ex;\n    __syncthreads();\n    K6_PHASE(2)\n"
                  "    if (active && !is_last) { atomicAdd(k6_dbg + 8, (unsigned long long)cnt);"
                  " atomicAdd(k6_dbg + 9, 1ull); }\n")
    src = replace(src, "      if (!__syncthreads_or(changed)) break;\n    }\n",
                  "      if (t == 0) atomicAdd(k6_dbg + 6, 1ull);\n"
                  "      if (!__syncthreads_or(changed)) break;\n    }\n    K6_PHASE(3)\n")
    src = replace(src, "      sh.carry_cnt = done;\n    }\n    __syncthreads();\n",
                  "      sh.carry_cnt = done;\n    }\n    __syncthreads();\n    K6_PHASE(4)\n")
    src = replace(src, "    __syncthreads();  // the window's shared state is free again\n",
                  "    __syncthreads();  // the window's shared state is free again\n"
                  "    K6_PHASE(5)\n")
    return replace(src, 'extern "C" {\n', '''extern "C" {
int k6_dbg_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, k6_dbg, sizeof(unsigned long long) * 16);
}
int k6_dbg_clear() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(k6_dbg, z, sizeof z);
}
''')


def sync_study(buf: bytes, hf, warms=(0, 64, 128, 256, 512), nchunks=64):
    """On the host: of the speculative starts a segment of 512 bits makes
    (each 512-bit boundary inside a chunk, warmed up from w bits before it),
    the share that has not found a true code boundary by the segment's
    first bit, for each w, over the first nchunks chunks."""
    n, cs, _, t, sizes, offsets = hf._parse(buf)
    lut = np.zeros(4096, np.int64)  # code length of each LSB-first peek
    for sym in np.flatnonzero(t.lengths):
        ln, code = int(t.lengths[sym]), int(t.codes[sym])
        lut[code | (np.arange(1 << (12 - ln)) << ln)] = ln
    data = np.frombuffer(buf, np.uint8)
    unsynced = dict.fromkeys(warms, 0)
    total = 0
    for c in range(min(nchunks, len(sizes))):
        bits = np.unpackbits(data[offsets[c]:offsets[c] + sizes[c]],
                             bitorder="little")
        bits = np.concatenate([bits, np.zeros(12, np.uint8)])
        peek = (bits[np.arange(bits.size - 12)[:, None] + np.arange(12)]
                << np.arange(12)).sum(axis=1)
        step = lut[peek]
        truth, pos = set(), 0
        while pos < bits.size - 12:
            truth.add(pos)
            pos += step[pos]
        for s0 in range(512, 8 * int(sizes[c]) - 8, 512):
            total += 1
            for w in warms:
                pos = max(s0 - w, 0)
                while pos < s0:
                    pos += step[pos]
                unsynced[w] += pos not in truth
    return total, {w: u / max(total, 1) for w, u in unsynced.items()}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=pathlib.Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import sprintz_tpu_torch
    from sprintz_tpu_torch.ops import huffman_kernels as hk
    from sprintz_tpu_torch.probes import decode_cases as dc
    from sprintz_tpu_torch.entropy import huffman as hf

    dev = torch.device("cuda")
    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    variants = {"as committed": src, "no table": untabled(src),
                "counters": counted(src), "async stage": async_stage(src),
                **{name: sized(src, *v) for name, v in SHAPES.items()}}
    if args.old is not None:
        variants["old"] = (args.old / "sprintz_tpu_torch" / "csrc"
                           / "huffman.cu").read_text()
    procs = {}
    for name, text in variants.items():
        stem = "k6_" + name.replace(" ", "_")
        (OUT / f"{stem}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [NVCC, *NVCC_FLAGS, "-o", str(OUT / f"{stem}.so"),
             str(OUT / f"{stem}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:  # a variant the card cannot take: skipped
            print(f"[build] {name}: nvcc failed, skipped: " + " | ".join(
                ln for ln in log.splitlines() if "error" in ln), flush=True)
            continue
        lines = log.splitlines()
        first = next(i for i, ln in enumerate(lines)
                     if "Compiling" in ln and "huff_decode_kernel" in ln)
        regs = next(ln for ln in lines[first:] if "registers" in ln)
        print(f"[build] {name}: {regs.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f"k6_{name.replace(' ', '_')}.so"))

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

    def caller(name, inputs):
        data, off, sz, lim, adj, perm, cs, n = inputs
        lib = libs[name]
        fn = lib.sprintz_huff_decode
        fn.restype = I
        out = torch.empty(hk.flag_offset(n) + 4, dtype=torch.uint8, device=dev)
        if name == "old":
            fn.argtypes = [P, P, P, P, P, P, P, L, I, L, P]
            call_args = (data.data_ptr(), off.data_ptr(), sz.data_ptr(),
                         lim.data_ptr(), adj.data_ptr(), perm.data_ptr(),
                         out.data_ptr(), off.shape[0], cs, n, stream)
        else:
            fn.argtypes = [P, L, P, P, P, P, P, P, L, I, L, P]
            call_args = (data.data_ptr(), data.shape[0], off.data_ptr(),
                         sz.data_ptr(), lim.data_ptr(), adj.data_ptr(),
                         perm.data_ptr(), out.data_ptr(), off.shape[0], cs, n,
                         stream)
        if name == "no table":
            lib.k6_set_tables.argtypes = [P, P, P]
            if lib.k6_set_tables(lim.data_ptr(), adj.data_ptr(),
                                 perm.data_ptr()):
                raise RuntimeError("k6_set_tables failed")

        def call():
            err = fn(*call_args)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        return call, out

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    rng = np.random.default_rng(0)
    walk = (np.cumsum(rng.integers(-6, 7, (1 << 17, 64)), axis=0) % 256
            ).astype(np.uint8)
    smooth = (np.cumsum(rng.integers(-2, 3, (1 << 17, 64)), axis=0) % 256
              ).astype(np.uint8)
    for what, x, cs in (("u8 walk 8 MiB", walk, 128),
                        ("u8 smooth 8 MiB", smooth, 4096)):
        inner = np.frombuffer(sprintz_tpu_torch.compress(x, device="cuda"),
                              np.uint8)
        buf = hf.huff_compress(inner, chunk_symbols=cs, allow_stored=False,
                               device=dev)
        inputs = dc.decode_inputs(buf, dev)
        n, nchunks = inputs[-1], inputs[1].shape[0]
        total, share = sync_study(buf, hf)
        print(f"[sync] {what}, cs {cs}: of {total} speculative 512-bit "
              f"segment starts, not on a true boundary after a warm-up of "
              + ", ".join(f"{w} bits {v:.3f}" for w, v in share.items()),
              flush=True)
        calls = {name: caller(name, inputs) for name in libs}
        want = None
        for name, (call, out) in calls.items():
            print(f"[check] {what}: {name}", flush=True)
            call()
            torch.cuda.synchronize()
            got = out[:n] if name == "old" else out
            if want is None:
                want = got.clone()
                if not np.array_equal(want[:n].cpu().numpy(), inner):
                    raise AssertionError(f"{what}: K6 differs from the data")
            elif not torch.equal(got, want[:got.shape[0]]):
                raise AssertionError(f"{what}: {name} differs from K6")
        order = list(calls) + list(calls)[::-1]
        times = {name: [] for name in calls}
        for name in order:
            times[name].append(time_ms(calls[name][0]))
        print(f"[time] {what} ({inner.size} symbols, {len(buf)} B container,"
              f" cs {cs}, {nchunks} chunks): " + ", ".join(
                  f"{name} {statistics.mean(v):.4f} ms ({v[0]:.4f}, "
                  f"{v[1]:.4f})" for name, v in times.items()), flush=True)
        lib = libs["counters"]
        host = (ctypes.c_ulonglong * 16)()
        lib.k6_dbg_clear()
        calls["counters"][0]()
        torch.cuda.synchronize()
        lib.k6_dbg_read(host)
        wins = host[N_WINDOWS]
        print(f"[counters] {what}: {wins} windows, "
              f"{host[N_ROUNDS] / wins:.3f} rounds a window (the last finds "
              f"no change), {host[N_SYMS] / max(host[N_SEGS], 1):.2f} "
              f"symbols a speculative segment; cycles a window: " + ", ".join(
                  f"{p} {host[i] / wins:.0f}" for i, p in enumerate(PHASES)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
