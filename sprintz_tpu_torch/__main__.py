"""Command-line interface: compress / decompress / info / query on files.

The port's counterpart of ``python -m sprintz_tpu``, with the same
commands, flags, containers, output and exit codes:

    python -m sprintz_tpu_torch compress  raw.bin out.spz --ndims 64 --dtype u8
    python -m sprintz_tpu_torch decompress out.spz roundtrip.bin
    python -m sprintz_tpu_torch info       out.spz
    python -m sprintz_tpu_torch query      out.spz --op sum

``--device cuda`` (the default) runs the device passes on the card and
fails without one; ``--device cpu`` runs the kernels' plain versions.

Container format v2 (``SPZT2``): magic + one flags byte (codec 2 bits,
elem-size 1 bit, entropy 2 bits, has-sidecar 1 bit) + an optional
checkpoint sidecar section (u32 length + ``checkpoint.Sidecar`` bytes) in
front of the reference-exact Sprintz stream, because the stream's
metadata records ndims but not element size, forecaster or entropy stage.
The sidecar (written by default for xff inputs of 16 KiB or more) lets
decompression run chunk-parallel. v1 (``SPZT1``) containers still read.
``--raw`` on both sides skips the container and reads/writes the bare
stream instead (then decompress/info/query need --codec/--dtype flags;
with --entropy huffman the raw file is the +Huf wrapper around the
reference stream, which the reference cannot decode). The files are
byte-identical to the JAX package's CLI's, and each CLI reads the other's.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

MAGIC = b"SPZT2"
MAGIC_V1 = b"SPZT1"
_CODECS = ["delta", "xff"]
_DTYPES = {"u8": 1, "u16": 2}
_ENTROPY = ["none", "huffman"]
_F_SIDECAR = 1 << 5


def _pack_flags(codec: str, elem_sz: int, entropy: str,
                has_sidecar: bool = False) -> bytes:
    ci, ei = _CODECS.index(codec), _ENTROPY.index(entropy)
    # each field must fit its width, so that a later addition fails loudly
    # instead of corrupting the neighbouring field
    assert 0 <= ci <= 3, f"codec index {ci} exceeds its 2-bit field"
    assert elem_sz in (1, 2), f"elem_sz {elem_sz} exceeds its 1-bit field"
    assert 0 <= ei <= 3, f"entropy index {ei} exceeds its 2-bit field"
    b = ci | ((elem_sz - 1) << 2) | (ei << 3)
    return bytes([b | (_F_SIDECAR if has_sidecar else 0)])


def _unpack_flags(b: int) -> tuple[str, int, str, bool]:
    return (_CODECS[b & 3], ((b >> 2) & 1) + 1, _ENTROPY[(b >> 3) & 3],
            bool(b & _F_SIDECAR))


def _read_container(buf: bytes, args):
    """Return (stream, codec, elem_sz, entropy, sidecar) from the
    container (v2 or v1) or from the --codec/--dtype/--entropy flags."""
    if not args.raw and buf[:5] == MAGIC:
        codec, elem_sz, entropy, has_sc = _unpack_flags(buf[5])
        pos = 6
        sc = None
        if has_sc:
            sc_len = int(np.frombuffer(buf, np.uint32, 1, offset=pos)[0])
            pos += 4
            from .checkpoint import Sidecar

            sc = Sidecar.from_bytes(buf[pos : pos + sc_len])
            pos += sc_len
        return buf[pos:], codec, elem_sz, entropy, sc
    if not args.raw and buf[:5] == MAGIC_V1:
        b = buf[5]  # v1 layout: 1-bit codec / elem / entropy fields
        return (buf[6:], _CODECS[b & 1], ((b >> 1) & 1) + 1,
                _ENTROPY[(b >> 2) & 1], None)
    if not args.raw:
        print("note: no SPZT container header; treating input as a raw "
              "reference stream (honoring --codec/--dtype/--entropy)",
              file=sys.stderr)
    return buf, args.codec, _DTYPES[args.dtype], args.entropy, None


def _plain_stream(stream: bytes, entropy: str, device: str) -> bytes:
    """The sprintz stream inside a +Huf file: decoded when it is a Huffman
    container, as it is when Huffman coding did not pay (the stored
    escape, which ``SprintzCodec.decompress`` routes on too)."""
    from .entropy import huff_decompress, is_container

    if entropy == "huffman" and is_container(stream):
        return huff_decompress(stream, device=device).tobytes()
    return stream


def _cmd_compress(args) -> int:
    from .api import SprintzCodec

    elem_sz = _DTYPES[args.dtype]
    dt = np.uint8 if elem_sz == 1 else np.uint16
    data = np.fromfile(args.infile, dtype=dt)
    if data.size % args.ndims:
        print(f"error: {data.size} elements not divisible by "
              f"--ndims {args.ndims}", file=sys.stderr)
        return 2
    codec = SprintzCodec(args.codec, elem_sz, entropy=args.entropy,
                         device=args.device)
    # the xff decode is a serial per-column recurrence without checkpoints,
    # so xff containers carry a sidecar by default (chunk-parallel decode);
    # "auto" skips it for small inputs and raw output
    want_sc = not args.raw and (
        args.sidecar == "always"
        or (args.sidecar == "auto" and args.codec == "xff"
            and data.nbytes >= (16 << 10)))
    if want_sc:
        stream, sc = codec.compress_seekable(data, ndims=args.ndims)
        sc_bytes = sc.to_bytes()
        out = (MAGIC + _pack_flags(args.codec, elem_sz, args.entropy, True)
               + np.uint32(len(sc_bytes)).tobytes() + sc_bytes + stream)
    else:
        stream = codec.compress(data, ndims=args.ndims)
        out = stream if args.raw else (
            MAGIC + _pack_flags(args.codec, elem_sz, args.entropy) + stream)
    with open(args.outfile, "wb") as f:
        f.write(out)
    print(f"{data.nbytes} -> {len(out)} bytes "
          f"(ratio {data.nbytes / max(len(out), 1):.3f}x)", file=sys.stderr)
    return 0


def _cmd_decompress(args) -> int:
    from .api import SprintzCodec

    with open(args.infile, "rb") as f:
        buf = f.read()
    stream, codec_name, elem_sz, entropy, sc = _read_container(buf, args)
    codec = SprintzCodec(codec_name, elem_sz, entropy=entropy,
                         device=args.device)
    out = codec.decompress(stream, sidecar=sc)
    np.asarray(out).tofile(args.outfile)
    print(f"{len(buf)} -> {np.asarray(out).nbytes} bytes", file=sys.stderr)
    return 0


def _cmd_info(args) -> int:
    from .stream_format import read_metadata_rle
    from .validate import validate_stream

    with open(args.infile, "rb") as f:
        buf = f.read()
    stream, codec_name, elem_sz, entropy, sc = _read_container(buf, args)
    stream = _plain_stream(stream, entropy, args.device)
    ngroups, remaining, ndims = read_metadata_rle(stream)
    rep = validate_stream(stream, elem_sz=elem_sz)
    print(f"codec:     {codec_name}")
    print(f"dtype:     uint{8 * elem_sz}")
    print(f"entropy:   {entropy}")
    if sc is not None:
        print(f"sidecar:   {len(sc.byte_offsets)} checkpoints "
              f"(every {sc.every_groups} groups)")
    print(f"ndims:     {ndims}")
    print(f"ngroups:   {ngroups}")
    print(f"remaining: {remaining} elements (verbatim tail)")
    tail_rows = remaining // max(ndims, 1) if ndims else remaining
    print(f"rows:      {rep.total_rows + tail_rows} "
          f"({rep.data_blocks} data blocks, {rep.run_blocks} run blocks)")
    print(f"bytes:     {len(buf)}")
    print(f"valid:     {rep.ok}"
          + ("" if rep.ok else f" ({'; '.join(rep.errors)})"))
    return 0 if rep.ok else 1


def _cmd_query(args) -> int:
    from .query import Operation, QueryParams, query

    with open(args.infile, "rb") as f:
        buf = f.read()
    stream, codec_name, elem_sz, entropy, _sc = _read_container(buf, args)
    stream = _plain_stream(stream, entropy, args.device)
    op = {"sum": Operation.REDUCE_SUM, "max": Operation.REDUCE_MAX,
          "min": Operation.REDUCE_MIN}[args.op]
    res = query(stream, QueryParams(op=op, materialize=False),
                codec=codec_name, elem_sz=elem_sz, device=args.device)
    print(np.asarray(getattr(res, args.op)).tolist())
    return 0


def _common_stream_flags(p):
    p.add_argument("--codec", choices=_CODECS, default="delta",
                   help="forecaster (raw streams only; containers carry it)")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="u8",
                   help="element type (raw streams only)")
    p.add_argument("--entropy", choices=_ENTROPY, default="none",
                   help="entropy stage (raw streams only)")
    p.add_argument("--raw", action="store_true",
                   help="treat the file as a bare reference-exact stream "
                        "(no SPZT container)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="sprintz-tpu-torch",
        description="Sprintz lossless time-series compression on PyTorch "
                    "and CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                     help="where the device passes run: 'cuda' (default; "
                          "fails without a card) or 'cpu' (the kernels' "
                          "plain PyTorch versions)")

    p = sub.add_parser("compress", help="compress a raw binary file",
                       parents=[dev])
    p.add_argument("infile")
    p.add_argument("outfile")
    p.add_argument("--ndims", type=int, default=1,
                   help="columns per row (row-major interleave)")
    p.add_argument("--codec", choices=_CODECS, default="delta")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="u8")
    p.add_argument("--entropy", choices=_ENTROPY, default="none")
    p.add_argument("--raw", action="store_true",
                   help="emit the bare stream with no container "
                        "(reference-exact when --entropy none; with "
                        "--entropy huffman it is the +Huf wrapper, which "
                        "the reference cannot decode)")
    p.add_argument("--sidecar", choices=["auto", "always", "never"],
                   default="auto",
                   help="embed a checkpoint sidecar for chunk-parallel "
                        "decode (auto = xff inputs >= 16 KiB)")
    p.set_defaults(fn=_cmd_compress)

    p = sub.add_parser("decompress", help="decompress to a raw binary file",
                       parents=[dev])
    p.add_argument("infile")
    p.add_argument("outfile")
    _common_stream_flags(p)
    p.set_defaults(fn=_cmd_decompress)

    p = sub.add_parser("info", help="print stream metadata + validation",
                       parents=[dev])
    p.add_argument("infile")
    _common_stream_flags(p)
    p.set_defaults(fn=_cmd_info)

    p = sub.add_parser("query", help="pushdown reduce without materializing",
                       parents=[dev])
    p.add_argument("infile")
    p.add_argument("--op", choices=["sum", "max", "min"], default="sum")
    _common_stream_flags(p)
    p.set_defaults(fn=_cmd_query)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
