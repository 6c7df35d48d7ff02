#!/usr/bin/env python3
"""Compare the SASS of ``csrc/fire.cu``'s kernels with an earlier copy's.

    python3 sprintz_tpu_torch/probes/fire_sass.py --old FILE [--new FILE]

Compiles both sources to cubins with the flags of ``ops/_build.py``
(``-cubin`` in place of ``-shared``), dumps their SASS with ``cuobjdump``
and matches the kernels by name and template arguments (demangled with
``cu++filt``). A template argument that the new source added last, with
the value false (the transform flag ``XF``, off for the codec's
instantiations), is dropped before matching. For each kernel of the old
source it prints whether its instructions are the same (addresses and
encodings stripped) and their counts; then the kernels only the new source
has (the transform instantiations) with their counts and registers. Its
last line is a JSON object of all of it; it exits 1 when a kernel of the
old source differs or is missing. Needs nvcc and cuobjdump (the chip
machine's toolkit); no card. Not imported by the port.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[2]
SRC = ROOT / "sprintz_tpu_torch" / "csrc" / "fire.cu"
TOOLKIT = pathlib.Path("/usr/local/cuda/bin")


def tool(name: str) -> str:
    found = shutil.which(name) or str(TOOLKIT / name)
    if not pathlib.Path(found).exists():
        raise SystemExit(f"{name} not found (PATH or {TOOLKIT})")
    return found


def flags() -> list[str]:
    sys.path.insert(0, str(ROOT))
    from sprintz_tpu_torch.ops import _build

    return [f for f in _build.NVCC_FLAGS
            if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")]


def sass(src: pathlib.Path, work: pathlib.Path) -> dict[str, dict]:
    """{kernel key: {"text": instructions, "n": count, "regs": registers}}."""
    cubin = work / f"{src.parent.name}_{src.stem}.cubin"
    subprocess.run([tool("nvcc"), *flags(), "-cubin", "-o", str(cubin),
                    str(src)], check=True)
    dump = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    res = subprocess.run([tool("cuobjdump"), "-res-usage", str(cubin)],
                         check=True, capture_output=True, text=True).stdout
    regs = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"Function (\S+):\s*REG:(\d+)", res)}
    out = {}
    for block in re.split(r"\n\s*Function : ", dump)[1:]:
        mangled, body = block.split("\n", 1)
        mangled = mangled.strip()
        lines = []
        for line in body.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
            if m:
                lines.append(m.group(1))
        out[mangled] = {"text": lines, "n": len(lines),
                        "regs": regs.get(mangled)}
    names = subprocess.run([tool("cu++filt")], input="\n".join(out),
                           capture_output=True, text=True, check=True).stdout
    keyed = {}
    for mangled, demangled in zip(out, names.splitlines()):
        m = re.search(r"(\w+)(?:<([^<>]*)>)?\(", demangled)
        args = tuple(a.strip() for a in (m.group(2) or "").split(",") if a.strip())
        keyed[(m.group(1), args)] = out[mangled]
    return keyed


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=pathlib.Path, required=True,
                    help="the earlier fire.cu")
    ap.add_argument("--new", type=pathlib.Path, default=SRC)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        (work / "old").mkdir()
        (work / "new").mkdir()
        old = sass(args.old.resolve(), work / "old")
        new = sass(args.new.resolve(), work / "new")
    matched, result, bad = set(), {"same": [], "differ": [], "added": []}, 0
    for (name, targs), o in sorted(old.items()):
        key = next((k for k in ((name, targs), (name, targs + ("(bool)0",)),
                                (name, targs + ("false",))) if k in new),
                   (name, targs))
        label = f"{name}<{', '.join(targs)}>"
        if key not in new:
            print(f"[sass] {label}: missing from the new source")
            result["differ"].append(label)
            bad = 1
            continue
        matched.add(key)
        n = new[key]
        same = o["text"] == n["text"]
        print(f"[sass] {label}: {'same SASS' if same else 'DIFFERS'} "
              f"({o['n']} / {n['n']} instructions, {o['regs']} / {n['regs']} "
              f"registers)")
        result["same" if same else "differ"].append(label)
        bad |= not same
    for (name, targs), n in sorted(new.items()):
        if (name, targs) not in matched:
            label = f"{name}<{', '.join(targs)}>"
            print(f"[sass] {label}: new ({n['n']} instructions, {n['regs']} "
                  f"registers)")
            result["added"].append({"kernel": label, "instructions": n["n"],
                                    "registers": n["regs"]})
    print(json.dumps(result))
    return bad


if __name__ == "__main__":
    sys.exit(main())
