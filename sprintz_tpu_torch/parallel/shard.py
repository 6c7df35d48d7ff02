"""Sharded (data-parallel) encode and decode over a mesh of shards.

Counterpart of ``sprintz_tpu/parallel/shard.py``. A stream's blocks are
cut into contiguous shards, one a device of a ``Mesh``, and each shard runs
the single-device kernels on its own rows; the shards exchange only small
tensors:

- encode: delta differences a shard's first row against its neighbour's
  last row (``ppermute`` of one row); FIRE's state is serial over the whole
  stream, so shard k scans once from shard k - 1's final carry
  (``fire_encode(init_state=, final=True)``, in shard order: the chain).
  Each shard's errors then take K3 ``pack_rows``; the shards' payload
  sizes are all-gathered and scanned into exclusive byte offsets. The
  errors of every block equal the single-device pass's, so ``dp_compress``
  (the plan and assembly on the host over the gathered headers and a
  compact payload) writes ``encoder.compress``'s bytes.
- decode from stream bytes (``dp_decompress``): the host walks the headers
  (split at a sidecar's checkpoints when there is one) and gathers the
  payload; the block timeline is cut into spans, even or at the sidecar's
  checkpoint rows; each shard places its data blocks on its span and
  decodes it. Delta: K1 on every shard, whose look-back leaves the shard's
  total in its status words; the totals are all-gathered, and each shard's
  exclusive prefix of them is added to its tile offsets before K2 (the
  lowdim decode, one kernel from sections to values, decodes from zero and
  takes its prefix in one add). FIRE with a sidecar: each shard's
  checkpoints start chunks from their recorded states (the short-chunk or
  ring chunked decode); FIRE without one: the chain, one serial decode a
  shard from its neighbour's final carry.

A ``Mesh`` is a frozen list of ``torch.device``s, one a shard; its
collectives are copies of small tensors between the shards' devices (on one
card, plain tensors). ``devices=["cpu"] * 8`` is the CPU tests' mesh (the
JAX tests' eight virtual host devices); ``devices=["cuda:0"] * 4`` puts four
shards on one card. ``multihost.ProcessMesh`` has the same collectives over
``torch.distributed`` processes, and every function here takes either.

The JAX package's ``dp_compress`` writes the row-major layout at every
ndims, so at the lowdim ndims (u8 <= 4, u16 <= 2) it writes a stream that
its own decoder reads as lowdim, wrongly. The port's raises ``ValueError``
there instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import decoder, encoder
from ..constants import (
    BLOCK_SZ,
    LOWDIM_MAX_NDIMS,
    METADATA_LEN_RLE,
    MIN_DATA_SIZE,
)
from ..device import resolve_device
from ..errors import CorruptStreamError
from ..models.forecasters import delta_encode, fire_decode, fire_encode
from ..ops.bitmath import header_to_width
from ..ops.decode_kernels import (decode_delta_lowdim, narrow, narrow_dtype,
                                  prefix_finish, unpack_zz, widen)
from ..planner import build_plan
from ..stream_format import read_metadata_rle, write_metadata_rle


# ------------------------------------------------------------------ mesh


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of shards in one process: ``devices[k]`` runs shard k.

    Its collectives move small tensors between the shards' devices; the
    sharded passes call them on the shards of this process (``local()``,
    here all of them), so that ``multihost.ProcessMesh`` can run the same
    passes with a shard a process."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def local(self) -> list[tuple[int, torch.device]]:
        """(shard, device) of every shard this process runs."""
        return list(enumerate(self.devices))

    def all_gather(self, parts: dict[int, torch.Tensor]
                   ) -> dict[int, torch.Tensor]:
        """Each shard's tensor (one shape) -> on each shard's device the
        (size, ...) stack of all of them, in shard order."""
        return {k: torch.stack([parts[j].to(dev) for j in range(self.size)])
                for k, dev in self.local()}

    def ppermute(self, parts: dict[int, torch.Tensor]
                 ) -> dict[int, torch.Tensor | None]:
        """Shard k's tensor to shard k + 1 (its device); shard 0 gets
        None."""
        return {k: None if k == 0 else parts[k - 1].to(dev)
                for k, dev in self.local()}

    def chain(self, step: Callable) -> dict[int, object]:
        """``step(k, carry) -> (out, carry)`` on every shard in shard order,
        each from the carry its predecessor returned (None on shard 0) ->
        {shard: out}."""
        outs, carry = {}, None
        for k, _ in self.local():
            outs[k], carry = step(k, carry)
        return outs

    def gather_host(self, parts: dict[int, torch.Tensor]
                    ) -> list[torch.Tensor]:
        """Every shard's tensor (first dims may differ) on the host, in
        shard order."""
        return [parts[k].cpu() for k in range(self.size)]


def make_mesh(n_shards: int | None = None, devices=None) -> Mesh:
    """A mesh of ``devices`` (names or ``torch.device``s; a device may hold
    several shards), cut to its first ``n_shards``. By default one shard on
    each visible CUDA device; raises without CUDA, as the entry points do."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs.append(dev)
    if n_shards is not None:
        if not 1 <= n_shards <= len(devs):
            raise ValueError(f"make_mesh: {n_shards} shards on "
                             f"{len(devs)} devices")
        devs = devs[:n_shards]
    if not devs:
        raise ValueError("make_mesh: no devices")
    return Mesh(tuple(devs))


def check_rowmajor(ndims: int, elem_sz: int, what: str) -> None:
    """The sharded encode writes the row-major layout: raise at the lowdim
    ndims, where a decoder would read the stream as lowdim."""
    if ndims <= LOWDIM_MAX_NDIMS[elem_sz]:
        raise ValueError(
            f"{what} writes the row-major layout, which a u{8 * elem_sz} "
            f"stream of ndims {ndims} does not have (u8 ndims <= 4 and u16 "
            f"ndims <= 2 are lowdim streams): use encoder.compress")


# --------------------------------------------------------------- encode


class EncodedShards(NamedTuple):
    """``dp_encode``'s outputs: each shard's (on its device) dense payload
    (nb_k, 8, D * elem_sz) uint8, widths and header fields (nb_k, D) int32;
    every shard's payload bytes and their exclusive prefix, (size,) int64
    on the host."""

    dense: dict[int, torch.Tensor]
    widths: dict[int, torch.Tensor]
    hdr: dict[int, torch.Tensor]
    sizes: np.ndarray
    offsets: np.ndarray


def upload_shards(mesh, rows: dict[int, np.ndarray]) -> dict[int, torch.Tensor]:
    """Each shard's (rows_k, D) u8/u16 rows -> int32 on its device."""
    return {k: encoder.upload_rows(rows[k], dev) for k, dev in mesh.local()}


def encode_shards(mesh, rows: dict[int, torch.Tensor], elem_sz: int,
                  codec: str = "delta") -> EncodedShards:
    """The sharded encode pass over each shard's int32 rows (a multiple of
    8 rows each, on its device): the forecast with its boundary state,
    then K3, then the payload sizes and offsets."""
    eb = 8 * elem_sz
    if codec == "delta":
        prev = mesh.ppermute({k: r[-1] for k, r in rows.items()})
        errs = {k: delta_encode(rows[k], eb, prev[k]) for k, _ in mesh.local()}
    elif codec == "xff":
        errs = mesh.chain(lambda k, carry: fire_encode(
            rows[k], eb, init_state=carry, final=True))
    else:
        raise ValueError(f"codec must be 'delta' or 'xff', got {codec!r}")
    out = {k: encoder.encode_errors(errs[k], elem_sz, False)
           for k, _ in mesh.local()}
    nbytes = {k: BLOCK_SZ * ((o[3].to(torch.int64) + 7) // 8).sum()
              for k, o in out.items()}
    sizes = mesh.all_gather(nbytes)[mesh.local()[0][0]].cpu().numpy()
    return EncodedShards(
        dense={k: o[2] for k, o in out.items()},
        widths={k: o[0] for k, o in out.items()},
        hdr={k: o[1] for k, o in out.items()},
        sizes=sizes, offsets=np.cumsum(sizes) - sizes)


def dp_encode(mesh, rows: np.ndarray, elem_sz: int,
              codec: str = "delta") -> EncodedShards:
    """Sharded block-parallel encode pass. rows: (total_rows, D) unsigned
    values (any integer dtype), total_rows divisible by 8 x the mesh's
    shards: shard k takes the k-th of equal parts, as a ``shard_map`` over
    the JAX package's mesh does."""
    rows = np.asarray(rows)
    per = rows.shape[0] // mesh.size
    if per * mesh.size != rows.shape[0] or per % BLOCK_SZ:
        raise ValueError(f"dp_encode: {rows.shape[0]} rows do not split into "
                         f"{mesh.size} shards of whole blocks")
    x = np.ascontiguousarray(rows).astype(
        np.uint8 if elem_sz == 1 else np.uint16, copy=False)
    parts = {k: x[k * per:(k + 1) * per] for k, _ in mesh.local()}
    return encode_shards(mesh, upload_shards(mesh, parts), elem_sz, codec)


# --------------------------------------------------------------- decode


def shard_totals_prefix(mesh, totals: dict[int, torch.Tensor],
                        elem_bits: int) -> dict[int, torch.Tensor]:
    """Each shard's (D,) total of deltas (wrapping) -> on its device, the
    exclusive prefix of the shards' totals before it, mod 2^elem_bits,
    int32: the value entering the shard (the cross-shard fix-up)."""
    allt = mesh.all_gather(totals)
    return {k: ((allt[k][:k].to(torch.int64).sum(dim=0))
                & ((1 << elem_bits) - 1)).to(torch.int32)
            for k, _ in mesh.local()}


def _delta_rowmajor(mesh, dense: dict, widths: dict, elem_bits: int):
    """Row-major delta over each shard's timeline (dense (nb_k, 8, MAXB),
    widths (nb_k, D) uint8): K1 on every shard, the totals' prefix folded
    into the tile offsets, K2 -> {shard: values (nb_k * 8, D)}."""
    k1 = {k: unpack_zz(dense[k], widths[k], elem_bits, total=True)
          for k, _ in mesh.local()}
    prefix = shard_totals_prefix(mesh, {k: o[2] for k, o in k1.items()},
                                 elem_bits)
    out = {}
    for k, _ in mesh.local():
        bz, toff, _ = k1[k]
        toff += prefix[k]
        out[k] = prefix_finish(bz.reshape(-1, bz.shape[2]), toff, elem_bits)
    return out


def _add_prefix(vals: torch.Tensor, prefix: torch.Tensor,
                elem_bits: int) -> torch.Tensor:
    """values (rows, D) u8/u16 + prefix (D,) int32, mod 2^elem_bits, in
    place: a narrow add wraps there (u16 through int16)."""
    p = narrow(prefix, elem_bits)
    if vals.dtype == torch.uint16:
        vals.view(torch.int16).add_(p.view(torch.int16))
    else:
        vals.add_(p)
    return vals


def _delta_lowdim(mesh, dense: dict, widths: dict, elem_bits: int):
    """Lowdim delta over each shard's timeline: the lowdim decode from zero
    on every shard, whose last row is its total mod 2^EB, then each
    shard's prefix added in place."""
    vals = {k: decode_delta_lowdim(dense[k], widths[k], elem_bits)
            for k, _ in mesh.local()}
    last = {k: (v[-1] if v.shape[0] else v.new_zeros(v.shape[1]))
            for k, v in vals.items()}  # an empty span adds nothing
    prefix = shard_totals_prefix(
        mesh, {k: widen(v) for k, v in last.items()}, elem_bits)
    return {k: _add_prefix(v, prefix[k], elem_bits) if k else v
            for k, v in vals.items()}


def _fire_chain_decode(mesh, errs: dict, elem_bits: int, lowdim: bool):
    """FIRE without a sidecar: each shard's serial decode from its
    neighbour's final carry, in shard order. An empty shard passes the
    carry on and launches nothing."""
    def step(k, carry):
        if errs[k].shape[0] == 0:
            return errs[k].new_zeros(errs[k].shape,
                                     dtype=narrow_dtype(elem_bits)), carry
        return fire_decode(errs[k], elem_bits, carry,
                           truncate_coeffs=not lowdim, final=True)
    return mesh.chain(step)


def dp_delta_decode(mesh, enc: EncodedShards, elem_sz: int):
    """Block-parallel delta decode of ``dp_encode``'s shards: K1, the
    cross-shard prefix of the shards' totals, K2 -> {shard: values
    (rows_k, D) u8/u16 on its device}."""
    return _delta_rowmajor(
        mesh, enc.dense, {k: w.to(torch.uint8) for k, w in enc.widths.items()},
        8 * elem_sz)


def dp_fire_decode(mesh, enc: EncodedShards, elem_sz: int):
    """Block-parallel unpack (K4, K5 at u8) and the FIRE decode chain over
    ``dp_encode``'s shards -> {shard: values (rows_k, D) u8/u16}."""
    errs = {k: decoder.fire_errors(enc.dense[k], enc.widths[k].to(torch.uint8),
                                   elem_sz, False)
            for k, _ in mesh.local()}
    return _fire_chain_decode(mesh, errs, 8 * elem_sz, False)


@dataclasses.dataclass
class ShardedStream:
    """A stream indexed for a sharded decode, on the host: each shard's
    data blocks (payload, widths, first rows from its span's start) and
    span, and, for FIRE with a sidecar, its chunks (first blocks and
    states)."""

    codec: str
    elem_sz: int
    ndims: int
    lowdim: bool
    total_rows: int
    tail: np.ndarray
    brows: np.ndarray  # (size + 1,) first row of every span, and the end
    dense: dict[int, np.ndarray]
    widths: dict[int, np.ndarray]
    out_rows: dict[int, np.ndarray]
    chunks: dict[int, tuple[np.ndarray, np.ndarray]] | None

    @property
    def spans(self) -> np.ndarray:
        return np.diff(self.brows)


def _sidecar_spans(sidecar, nshards: int, nbt: int, ndims: int):
    """Span boundaries snapped to the sidecar's checkpoint rows (the FIRE
    state is known only there), as the JAX package snaps them; with fewer
    checkpoints than shards the last spans are empty. -> (brows, the
    checkpoints inside each span)."""
    ro = np.asarray(sidecar.row_offsets, dtype=np.int64)
    targets = (np.arange(1, nshards) * nbt * BLOCK_SZ) // nshards
    ck = np.unique(np.searchsorted(ro, targets, side="right") - 1)
    ck = ck[ck > 0]
    brows = np.concatenate([[0], ro[ck],
                            np.full(nshards - 1 - len(ck), nbt * BLOCK_SZ),
                            [nbt * BLOCK_SZ]]).astype(np.int64)
    states = np.zeros((ro.size, 3, ndims), np.int32)
    states[:, : sidecar.states.shape[1]] = sidecar.states
    chunks = {}
    for k in range(nshards):
        inside = np.flatnonzero((ro >= brows[k]) & (ro < brows[k + 1]))
        chunks[k] = ((ro[inside] - brows[k]) // BLOCK_SZ, states[inside])
    return brows, chunks


def index_stream(mesh, buf: bytes, codec: str = "delta", elem_sz: int = 1,
                 sidecar=None) -> ShardedStream | np.ndarray:
    """The host side of ``dp_decompress``: the header walk (split at a
    sidecar's checkpoints when there is one), the payload gather, the
    spans and each shard's data blocks. A verbatim stream, or one without
    coded rows, comes back as its elements."""
    if codec not in ("delta", "xff"):
        raise ValueError(f"codec must be 'delta' or 'xff', got {codec!r}")
    if elem_sz not in (1, 2):
        raise ValueError(f"elem_sz must be 1 or 2, got {elem_sz}")
    udt = np.uint8 if elem_sz == 1 else np.uint16
    if len(buf) < METADATA_LEN_RLE:
        raise CorruptStreamError(
            f"stream shorter than its {METADATA_LEN_RLE}-byte metadata "
            f"({len(buf)} bytes)")
    ngroups, remaining_len, ndims = read_metadata_rle(buf)
    if ndims == 0 and not (ngroups == 0 and remaining_len == 0):
        raise CorruptStreamError("metadata declares 0 dims")
    if ngroups == 0 and remaining_len < MIN_DATA_SIZE:
        if len(buf) < METADATA_LEN_RLE + remaining_len * elem_sz:
            raise CorruptStreamError("verbatim stream truncated")
        return np.frombuffer(buf, dtype=udt, count=remaining_len,
                             offset=METADATA_LEN_RLE).copy()
    lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]
    if sidecar is not None:
        ro = np.asarray(sidecar.row_offsets, dtype=np.int64)
        if ro.size and (ro[0] != 0 or np.any(np.diff(ro) < 0)
                        or np.any(ro % BLOCK_SZ)):
            raise CorruptStreamError(
                "sidecar inconsistent with stream: checkpoint rows must "
                "rise from row 0 on block boundaries")
        idx = decoder.walk_headers_parallel(
            buf, ngroups, ndims, elem_sz,
            np.asarray(sidecar.byte_offsets, dtype=np.int64), ro,
            sidecar.every_groups, lowdim)
    else:
        idx = decoder.walk_headers(buf, ngroups, ndims, elem_sz, lowdim)
    if idx.tail_offset + remaining_len * elem_sz > len(buf):
        raise CorruptStreamError(
            f"verbatim tail truncated: need "
            f"{idx.tail_offset + remaining_len * elem_sz} bytes, "
            f"have {len(buf)}")
    tail = np.frombuffer(buf, dtype=udt, count=remaining_len,
                         offset=idx.tail_offset)
    if idx.total_rows == 0:
        return tail.copy()
    dense = decoder.gather_payloads(buf, idx)
    nbt = idx.total_rows // BLOCK_SZ
    n = mesh.size
    chunks = None
    if codec == "xff" and sidecar is not None and len(sidecar.row_offsets) > 1:
        brows, chunks = _sidecar_spans(sidecar, n, nbt, ndims)
    else:
        per = -(-nbt // n)
        brows = np.minimum(np.arange(n + 1) * per, nbt) * BLOCK_SZ
    # out_rows is sorted, so each shard's data blocks are one slice
    lo = np.searchsorted(idx.out_rows, brows[:-1], side="left")
    hi = np.searchsorted(idx.out_rows, brows[1:], side="left")
    return ShardedStream(
        codec=codec, elem_sz=elem_sz, ndims=ndims, lowdim=lowdim,
        total_rows=idx.total_rows, tail=tail, brows=brows,
        dense={k: dense[lo[k]:hi[k]] for k in range(n)},
        widths={k: idx.widths[lo[k]:hi[k]] for k in range(n)},
        out_rows={k: idx.out_rows[lo[k]:hi[k]] - brows[k] for k in range(n)},
        chunks=chunks)


def upload_stream(mesh, job: ShardedStream) -> dict[int, tuple]:
    """Each local shard's payload, widths and first rows on its device."""
    return {k: (torch.from_numpy(job.dense[k]).to(dev),
                torch.from_numpy(job.widths[k]).to(dev),
                torch.from_numpy(job.out_rows[k]).to(dev))
            for k, dev in mesh.local()}


def decode_shards(mesh, job: ShardedStream, up: dict[int, tuple]
                  ) -> dict[int, torch.Tensor]:
    """The device pass of ``dp_decompress``: each shard's blocks placed on
    its span, then the reconstruction with its collectives -> {shard:
    values (span_k, D) u8/u16 on its device}."""
    eb = 8 * job.elem_sz
    spans = job.spans
    placed = {k: decoder.place_blocks(*up[k], int(spans[k]))
              for k, _ in mesh.local()}
    if job.codec == "delta":
        dense = {k: p[0] for k, p in placed.items()}
        widths = {k: p[1] for k, p in placed.items()}
        if job.lowdim:
            return _delta_lowdim(mesh, dense, widths, eb)
        return _delta_rowmajor(mesh, dense, widths, eb)
    errs = {k: decoder.fire_errors(*placed[k], job.elem_sz, job.lowdim)
            for k, _ in mesh.local()}
    if job.chunks is None:
        return _fire_chain_decode(mesh, errs, eb, job.lowdim)
    out = {}
    for k, _ in mesh.local():
        first, states = job.chunks[k]
        if spans[k] == 0:  # no checkpoint here: nothing to launch
            out[k] = errs[k].new_zeros((0, job.ndims), dtype=narrow_dtype(eb))
            continue
        out[k] = decoder.decode_device(
            *up[k], int(spans[k]), job.elem_sz, "xff", job.lowdim,
            chunks=(first, states))
    return out


def gather_rows(mesh, vals: dict[int, torch.Tensor]) -> np.ndarray:
    """Every shard's values (rows_k, D) u8/u16 on the host, in shard order
    -> (rows, D)."""
    parts = mesh.gather_host(vals)
    return np.concatenate([decoder.download_values(p).reshape(p.shape)
                           for p in parts])


def download_values(mesh, vals: dict[int, torch.Tensor],
                    job: ShardedStream) -> np.ndarray:
    """Every shard's values on the host, in order, and the verbatim tail ->
    the stream's flat elements. In one process each shard's values come
    down straight into their place in the result (one copy); across
    processes they come through the gather."""
    out = np.empty(job.total_rows * job.ndims + job.tail.size,
                   dtype=job.tail.dtype)
    parts = (vals if isinstance(mesh, Mesh)
             else dict(enumerate(mesh.gather_host(vals))))
    at = 0
    for k in range(mesh.size):
        v = parts[k]
        dst = out[at:at + v.numel()]
        if v.dtype == torch.uint16:  # a storage type: copied as int16
            v, dst = v.view(torch.int16), dst.view(np.int16)
        torch.from_numpy(dst).copy_(v.reshape(-1))
        at += v.numel()
    out[at:] = job.tail
    return out


def dp_decompress(mesh, buf: bytes, codec: str = "delta", elem_sz: int = 1,
                  sidecar=None, out: str = "numpy"):
    """Sharded decode of a compressed stream (either layout, either codec)
    -> ``decoder.decompress``'s elements.

    ``out="numpy"``: the flat elements on the host. ``out="sharded"``:
    (values, spans, total_rows, tail): values {shard: (span_k, D) u8/u16 on
    its device}, span k the rows of shard k, in order; the tail on the
    host."""
    if out not in ("numpy", "sharded"):
        raise ValueError(f"out must be 'numpy' or 'sharded', got {out!r}")
    job = index_stream(mesh, buf, codec, elem_sz, sidecar)
    if isinstance(job, np.ndarray):
        return job
    vals = decode_shards(mesh, job, upload_stream(mesh, job))
    if out == "sharded":
        return vals, job.spans, job.total_rows, job.tail
    return download_values(mesh, vals, job)


# ------------------------------------------------------------ full step


def gather_dense_compact(mesh, dense: dict[int, torch.Tensor],
                         widths_np: np.ndarray, block_starts: np.ndarray
                         ) -> np.ndarray:
    """Each shard's dense payload (nb_k, 8, MAXB) -> the whole (nb, 8,
    MAXB) uint8 on the host, moving about the compressed bytes: blocks
    are bucketed by payload row bytes ceil(sum(widths) / 8) rounded up to 8
    (at most MAXB), each shard packs its blocks' bucket-wide rows into one
    flat tensor on its device, which comes down (or across processes) in
    one copy; run blocks (width 0) move nothing. Bytes past a block's
    bucket, and blocks of width 0, are left unwritten: the assembler reads
    only a block's ceil(sum(widths) / 8) bytes a row.
    ``block_starts``: (size + 1,) every shard's first block, and the end."""
    nb, ndims = widths_np.shape
    maxb = next(iter(dense.values())).shape[2]
    rb = (widths_np.sum(axis=1, dtype=np.int64) + 7) // 8
    rbb = np.minimum((rb + 7) // 8 * 8, maxb)
    buckets = [int(b) for b in np.unique(rbb) if b > 0]
    parts = {}
    for k, dev in mesh.local():
        own = rbb[block_starts[k]:block_starts[k + 1]]
        pieces = [dense[k].new_zeros(0)]
        for b in buckets:
            idx = torch.from_numpy(np.flatnonzero(own == b)).to(dev)
            pieces.append(dense[k][idx, :, :b].reshape(-1))
        parts[k] = torch.cat(pieces)
    flat = np.concatenate([p.numpy() for p in mesh.gather_host(parts)])
    out = np.empty((nb, BLOCK_SZ, maxb), np.uint8)
    at = 0
    for k in range(mesh.size):
        own = rbb[block_starts[k]:block_starts[k + 1]]
        for b in buckets:
            idx = np.flatnonzero(own == b)
            m = idx.size * BLOCK_SZ * b
            out[block_starts[k] + idx, :, :b] = flat[at:at + m].reshape(
                -1, BLOCK_SZ, b)
            at += m
    return out


def shard_rows(flat: np.ndarray, ndims: int, nshards: int,
               shards: list[int]) -> tuple[dict[int, np.ndarray], int]:
    """``flat``'s whole blocks cut into ``nshards`` equal shards of whole
    blocks, the last padded with zero rows (the plan never reads a padding
    block) -> ({shard: its (rows_k, D) rows} for ``shards``, the blocks
    before the padding)."""
    block_elems = BLOCK_SZ * ndims
    nb_max = flat.size // block_elems
    per = -(-nb_max // nshards) * BLOCK_SZ
    rows = flat[: nb_max * block_elems].reshape(-1, ndims)
    out = {}
    for k in shards:
        part = rows[k * per:(k + 1) * per]
        if part.shape[0] < per:
            part = np.concatenate(
                [part, np.zeros((per - part.shape[0], ndims), flat.dtype)])
        out[k] = part
    return out, nb_max


def download_encoded(mesh, enc: EncodedShards, elem_sz: int):
    """Every shard's header fields and compact payload on the host ->
    (widths, header fields (nb, D) uint8, dense (nb, 8, MAXB) uint8): the
    widths follow from the 1-byte fields (eb - 1 stores width eb), so only
    the fields and the bucketed payload move."""
    hdrs = [h.numpy() for h in mesh.gather_host(
        {k: h.to(torch.uint8) for k, h in enc.hdr.items()})]
    hdr_np = np.concatenate(hdrs)
    widths_np = header_to_width(hdr_np, 8 * elem_sz)
    starts = np.cumsum([0] + [h.shape[0] for h in hdrs])
    return widths_np, hdr_np, gather_dense_compact(mesh, enc.dense, widths_np,
                                                   starts)


def assemble(widths_np: np.ndarray, hdr_np: np.ndarray, dense_np: np.ndarray,
             flat_tail: Callable[[int], np.ndarray], n: int, ndims: int,
             elem_sz: int, codec: str, nb_max: int) -> bytes:
    """The plan (RLE runs may cross shard boundaries) and the assembly of
    ``encoder.compress``'s bytes over the first ``nb_max`` blocks, on the
    host. ``flat_tail(k)``: the stream's last k elements."""
    wsums = widths_np.sum(axis=1, dtype=np.int32)
    plan = build_plan(wsums[:nb_max] == 0, n, ndims, codec == "xff")
    return encoder.assemble_stream(
        plan, widths_np, hdr_np, dense_np, ndims, elem_sz,
        flat_tail(plan.remaining_elems), False, wsums)


def dp_compress(mesh, flat: np.ndarray, ndims: int,
                codec: str = "delta") -> bytes:
    """Sharded compress of a flat u8/u16 stream -> ``encoder.compress``'s
    bytes (row-major ndims only: raises ``ValueError`` at u8 ndims <= 4
    and u16 ndims <= 2). The blocks are cut into equal shards (the last
    padded with zero rows); the boundary state rides ``ppermute`` (a row)
    or the FIRE chain, so every block's errors equal the single-device
    pass's; the plan and the assembly run on the host over the gathered
    headers and the compact payload."""
    flat = np.ascontiguousarray(flat).reshape(-1)
    if flat.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"expected a uint8 or uint16 stream, got {flat.dtype}")
    if codec not in ("delta", "xff"):
        raise ValueError(f"codec must be 'delta' or 'xff', got {codec!r}")
    elem_sz = flat.dtype.itemsize
    if ndims < 1:
        raise ValueError(f"ndims must be >= 1, got {ndims}")
    check_rowmajor(ndims, elem_sz, "dp_compress")
    n = flat.size
    if n < MIN_DATA_SIZE:
        return write_metadata_rle(0, n, ndims) + flat.tobytes()
    rows, nb_max = shard_rows(flat, ndims, mesh.size,
                              [k for k, _ in mesh.local()])
    if nb_max == 0:  # no whole block: nothing to shard
        return encoder.compress(flat, ndims, codec,
                                device=mesh.local()[0][1])
    enc = encode_shards(mesh, upload_shards(mesh, rows), elem_sz, codec)
    return assemble(*download_encoded(mesh, enc, elem_sz),
                    lambda r: flat[n - r:], n, ndims, elem_sz, codec, nb_max)


def training_step(mesh, rows: np.ndarray, elem_sz: int = 1,
                  codec: str = "delta"):
    """One sharded encode -> decode round trip (the JAX package's dry run
    and scaling step): rows (total_rows, D) as ``dp_encode`` takes them ->
    ({shard: decoded rows on its device}, the payload's total bytes)."""
    enc = dp_encode(mesh, rows, elem_sz, codec)
    if codec == "delta":
        decoded = dp_delta_decode(mesh, enc, elem_sz)
    else:
        decoded = dp_fire_decode(mesh, enc, elem_sz)
    return decoded, int(enc.sizes.sum())
