"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

At first use every ``csrc/*.cu`` is compiled for ``sm_90a`` into a shared
library with a plain C interface, one library per source, all sources
compiled at once. Libraries land in ``build/sprintz_tpu_torch/`` at the
root of the checkout, named by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused. A missing
``nvcc`` or a failed build raises; nothing falls back to another path.

Each C entry point returns ``cudaGetLastError()`` after its launch, and
``launch`` raises when that is not 0: a launch the card refuses never
runs, and a later synchronize would not report it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2] / "build"
             / "sprintz_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
NVCC_TOOLKIT_PATH = "/usr/local/cuda/bin/nvcc"  # the toolkit's default

# argtypes of the C entry points: c_void_p for every pointer and the
# stream (a plain c_int would cut a 64-bit pointer).
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "sprintz_unpack_zz": ("decode", (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                                     _P, _I, _P, _P)),
    "sprintz_prefix_finish": ("decode", (_P, _P, _P, _L, _I, _I, _P, _I, _P,
                                         _P)),
    "sprintz_decode_lowdim": ("decode", (_P, _P, _P, _P, _L, _I, _I, _I, _P,
                                         _I, _P, _P)),
    "sprintz_pack_rows": ("pack", (_P, _P, _P, _L, _I, _I, _I, _P)),
    "sprintz_encode_lowdim": ("pack", (_P, _P, _P, _P, _P, _L, _I, _I, _I,
                                       _P)),
    "sprintz_fire_scan": ("fire", (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                                   _P)),
    "sprintz_fire_decode_chunks": ("fire", (_P, _P, _P, _I, _P, _L, _I, _I,
                                            _I, _P)),
    "sprintz_fire_decode_short": ("fire", (_P, _P, _P, _I, _L, _P, _L, _I,
                                           _I, _I, _P)),
    "sprintz_fire_chain_probe": ("fire", (_P, _L, _I, _P)),
    "sprintz_huff_decode": ("huffman", (_P, _L, _P, _P, _P, _P, _P, _P, _L,
                                        _I, _L, _P)),
    "sprintz_huff_encode_sizes": ("huffman", (_P, _P, _P, _L, _I, _I, _P)),
    "sprintz_huff_encode_emit": ("huffman", (_P, _P, _P, _P, _P, _P, _L, _I,
                                             _I, _P)),
    "sprintz_prefix_finish_reduce": ("decode", (_P, _P, _P, _L, _I, _I, _I,
                                                _P, _I, _I, _P, _P, _P)),
    "sprintz_decode_lowdim_reduce": ("decode", (_P, _P, _P, _P, _L, _I, _I,
                                                _I, _P, _I, _I, _P, _P, _P)),
    "sprintz_reduce_cols": ("query", (_P, _P, _P, _L, _I, _I, _I, _I, _P,
                                      _P)),
}
ERROR_STRING_LIB = "decode"  # the library that defines sprintz_error_string


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or NVCC_TOOLKIT_PATH
    if not os.path.exists(nvcc):
        raise RuntimeError(
            f"nvcc not found (PATH or {NVCC_TOOLKIT_PATH}): the CUDA "
            f"kernels of sprintz_tpu_torch cannot be built")
    return nvcc


def _target(src: pathlib.Path) -> pathlib.Path:
    key = hashlib.sha256(
        " ".join(NVCC_FLAGS).encode() + b"\0" + src.read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}_{key[:16]}.so"


def build() -> dict[str, pathlib.Path]:
    """Compile every source whose library is missing, all in parallel.

    Returns {source stem: library path}. The compiler's output (with
    ``-Xptxas=-v``: registers, shared memory and spills per kernel) is
    kept beside each library as ``.log``.
    """
    sources = sorted(CSRC.glob("*.cu"))
    libs = {src.stem: _target(src) for src in sources}
    todo = [src for src in sources if not libs[src.stem].exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with contextlib.ExitStack() as logs:
            procs = []
            for src in todo:
                tmp = libs[src.stem].with_suffix(f".{os.getpid()}.tmp")
                log = logs.enter_context(
                    open(libs[src.stem].with_suffix(".log"), "wb"))
                procs.append((src, tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=log, stderr=subprocess.STDOUT)))
            done = [(src, tmp, proc.wait()) for src, tmp, proc in procs]
        failed = []
        for src, tmp, rc in done:
            if rc == 0:
                os.replace(tmp, libs[src.stem])
            else:
                failed.append(f"{src.name} (rc {rc}): "
                              + libs[src.stem].with_suffix(".log").read_text())
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


@functools.cache
def _libraries() -> dict[str, ctypes.CDLL]:
    libs = {stem: ctypes.CDLL(str(path)) for stem, path in build().items()}
    errstr = libs[ERROR_STRING_LIB].sprintz_error_string
    errstr.argtypes = [ctypes.c_int]
    errstr.restype = ctypes.c_char_p
    for name, (stem, argtypes) in SIGNATURES.items():
        fn = getattr(libs[stem], name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return libs


def launch(name: str, like: torch.Tensor, *args) -> None:
    """Call C entry point ``name`` on ``like``'s device, with PyTorch's
    current stream there as its last argument; raise if the launch was
    refused."""
    stem, _ = SIGNATURES[name]
    libs = _libraries()
    with torch.cuda.device(like.device):
        err = getattr(libs[stem], name)(
            *args, torch.cuda.current_stream(like.device).cuda_stream)
    if err:
        msg = libs[ERROR_STRING_LIB].sprintz_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
