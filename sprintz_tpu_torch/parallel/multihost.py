"""Multi-process encode and decode over ``torch.distributed``.

Counterpart of ``sprintz_tpu/parallel/multihost.py``. A ``ProcessMesh``
runs one shard a process (rank r runs shard r on its own device) and has
the collectives of ``shard.Mesh``, so the sharded passes of ``shard.py``
run on it unchanged: ``ppermute`` is a send to the next rank and a receive
from the previous one, the FIRE chain receives its carry from rank r - 1
and sends it on to rank r + 1, and ``all_gather`` and the gathers to the
host are ``all_gather``s of tensors padded to one shape. What crosses
processes is what the JAX package moves through host memory: sizes, header
fields, the compact payload, boundary rows and carries, and, for a decode
to the host, the values.

The caller names the backend (``maybe_init_distributed``), and nothing
switches it: ``"nccl"`` where each rank has a card of its own (the wire is
then that card), ``"gloo"`` on the CPU, or for ranks that share one card
(the compute stays on the card; the wire is host memory).

Each process passes only its own slice of the input to ``mp_compress``
(``host_local_elems``) and gets the whole stream back, the bytes of
``encoder.compress``; ``mp_decompress`` decodes a stream that every
process holds into the whole array on every process.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import encoder
from ..constants import BLOCK_SZ, MIN_DATA_SIZE
from ..device import resolve_device
from ..ops.decode_kernels import narrow, widen
from ..stream_format import write_metadata_rle
from . import shard

_DTYPES = [torch.int32, torch.int64, torch.uint8, torch.uint16]


def maybe_init_distributed(backend: str) -> bool:
    """Join the process group that torch's own variables describe
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as
    ``torchrun`` sets them), over ``backend`` ("nccl" or "gloo"). Returns
    True when a process group is up (already, or now). Safe to call
    again."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if dist.is_available() and dist.is_initialized():
        return True
    env = [os.environ.get(k) for k in
           ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")]
    if not all(env):
        return False
    addr, port, world, rank = env
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            world_size=int(world), rank=int(rank))
    return True


def _rank_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _wire(device: torch.device) -> torch.device:
    """Where a collective's tensors travel: the card for NCCL, else host
    memory."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return device
    return torch.device("cpu")


def _to_wire(t: torch.Tensor, wire: torch.device) -> torch.Tensor:
    """A tensor as it travels: on the wire's device, contiguous; uint16
    (a storage type in torch, which the backends do not all take) widened
    to int32."""
    if t.dtype == torch.uint16:
        t = widen(t)
    return t.to(wire).contiguous()


def _from_wire(t: torch.Tensor, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    t = t.to(device)
    return narrow(t, 16) if dtype == torch.uint16 else t


def _send(t: torch.Tensor | None, dst: int, device: torch.device) -> None:
    """A tensor (or None) to rank ``dst``: its shape and dtype, then it."""
    wire = _wire(device)
    head = torch.full((6,), -1, dtype=torch.int64)
    if t is not None:
        if t.dim() > 4:
            raise ValueError("a point-to-point tensor has at most 4 dims")
        head[0], head[1] = t.dim(), _DTYPES.index(t.dtype)
        head[2:2 + t.dim()] = torch.tensor(t.shape)
    dist.send(head.to(wire), dst)
    if t is not None:
        dist.send(_to_wire(t, wire), dst)


def _recv(src: int, device: torch.device) -> torch.Tensor | None:
    wire = _wire(device)
    head = torch.empty(6, dtype=torch.int64, device=wire)
    dist.recv(head, src)
    head = head.cpu()
    if head[0] < 0:
        return None
    shape = tuple(int(x) for x in head[2:2 + int(head[0])])
    dtype = _DTYPES[int(head[1])]
    t = torch.empty(shape, device=wire,
                    dtype=torch.int32 if dtype == torch.uint16 else dtype)
    dist.recv(t, src)
    return _from_wire(t, dtype, device)


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """A 1-D mesh of one shard a process: this process runs shard ``rank``
    of ``size`` on ``device``. Its collectives are ``shard.Mesh``'s, over
    the process group."""

    device: torch.device
    rank: int
    size: int

    def local(self) -> list[tuple[int, torch.device]]:
        return [(self.rank, self.device)]

    def all_gather(self, parts: dict[int, torch.Tensor]
                   ) -> dict[int, torch.Tensor]:
        t = parts[self.rank]
        if self.size == 1:
            return {self.rank: t[None]}
        mine = _to_wire(t, _wire(self.device))
        got = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(got, mine)
        return {self.rank: _from_wire(torch.stack(got), t.dtype, self.device)}

    def ppermute(self, parts: dict[int, torch.Tensor]
                 ) -> dict[int, torch.Tensor | None]:
        wire = _wire(self.device)
        mine = _to_wire(parts[self.rank], wire)  # the neighbour's is alike
        req = None
        if self.rank + 1 < self.size:
            req = dist.isend(mine, self.rank + 1)
        got = None
        if self.rank > 0:
            buf = torch.empty_like(mine)
            dist.recv(buf, self.rank - 1)
            got = _from_wire(buf, parts[self.rank].dtype, self.device)
        if req is not None:
            req.wait()
        return {self.rank: got}

    def chain(self, step) -> dict[int, object]:
        carry = None
        if self.rank > 0:
            carry = _recv(self.rank - 1, self.device)
        out, carry = step(self.rank, carry)
        if self.rank + 1 < self.size:
            _send(carry, self.rank + 1, self.device)
        return {self.rank: out}

    def gather_host(self, parts: dict[int, torch.Tensor]
                    ) -> list[torch.Tensor]:
        t = parts[self.rank]
        if self.size == 1:
            return [t.cpu()]
        wire = _wire(self.device)
        n = torch.tensor([t.shape[0]], dtype=torch.int64, device=wire)
        counts = [torch.empty_like(n) for _ in range(self.size)]
        dist.all_gather(counts, n)
        counts = [int(c) for c in counts]
        mine = _to_wire(t, wire)
        pad = mine.new_zeros((max(counts),) + tuple(t.shape[1:]))
        pad[: t.shape[0]] = mine
        got = [torch.empty_like(pad) for _ in range(self.size)]
        dist.all_gather(got, pad)
        return [_from_wire(g[:c], t.dtype, torch.device("cpu"))
                for g, c in zip(got, counts)]


def global_mesh(device: str | torch.device | None = None) -> ProcessMesh:
    """The mesh of every process of the group, one shard each (a mesh of
    one shard without a group). ``device``: this process's, by default
    CUDA device ``LOCAL_RANK`` (else the rank) modulo the visible ones;
    ``"cpu"`` for tests. Raises without CUDA unless the caller names
    another device."""
    rank, world = _rank_world()
    if device is None:
        resolve_device("cuda")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return ProcessMesh(resolve_device(device), rank, world)


def host_local_rows(total_rows: int, block_rows: int = BLOCK_SZ,
                    rank: int | None = None,
                    world: int | None = None) -> slice:
    """The rows this process feeds a sharded encode: contiguous, whole
    blocks, in process order. ``rank``/``world``: the process group's by
    default."""
    r, w = _rank_world()
    rank, world = (r if rank is None else rank), (w if world is None else world)
    blocks = total_rows // block_rows
    per = -(-blocks // world)
    return slice(min(rank * per, blocks) * block_rows,
                 min((rank + 1) * per, blocks) * block_rows)


def host_local_elems(total_len: int, ndims: int, n_dev: int | None = None,
                     rank: int | None = None,
                     world: int | None = None) -> slice:
    """The elements this process passes to ``mp_compress``: contiguous and
    whole blocks, the blocks padded to a multiple of the ``n_dev`` shards
    (the world size by default) and split evenly across processes; the last
    process also owns the tail that fills no block. ``rank``/``world``:
    the process group's by default."""
    r, w = _rank_world()
    rank, world = (r if rank is None else rank), (w if world is None else world)
    n_dev = n_dev or world
    block_elems = BLOCK_SZ * ndims
    nb_max = total_len // block_elems
    nb_pad = -(-nb_max // n_dev) * n_dev if nb_max else 0
    bpp = nb_pad // world
    lo = min(rank * bpp * block_elems, total_len)
    hi = min((rank + 1) * bpp * block_elems, total_len)
    if rank == world - 1:
        hi = total_len
    return slice(lo, hi)


def _allgather_window(local_flat: np.ndarray, lo: int, t0: int, t1: int,
                      mesh: ProcessMesh) -> np.ndarray:
    """Elements [t0, t1) of the whole flat array on every process, from the
    processes' slices (each element is one process's, so the sum of the
    gathered windows is the merge)."""
    buf = np.zeros(t1 - t0, dtype=local_flat.dtype)
    s0, s1 = max(t0, lo), min(t1, lo + local_flat.size)
    if s1 > s0:
        buf[s0 - t0: s1 - t0] = local_flat[s0 - lo: s1 - lo]
    if mesh.size == 1:
        return buf
    parts = mesh.all_gather({mesh.rank: torch.from_numpy(
        buf.astype(np.int32)).to(mesh.device)})[mesh.rank]
    return parts.sum(dim=0).cpu().numpy().astype(local_flat.dtype)


def mp_compress(local_flat: np.ndarray, total_len: int, ndims: int,
                codec: str = "delta", mesh: ProcessMesh | None = None
                ) -> bytes:
    """Multi-process compress: each process passes only
    ``flat[host_local_elems(total_len, ndims)]``; every process returns
    ``encoder.compress``'s bytes of the whole stream (row-major ndims
    only, as ``shard.dp_compress``). Each process encodes its blocks as a
    shard (the last process's padded with zero rows), with the boundary
    row or FIRE carry from the previous process; the header fields and the
    compact payload are all-gathered and every process plans and
    assembles."""
    mesh = mesh or global_mesh()
    local_flat = np.ascontiguousarray(local_flat).reshape(-1)
    if local_flat.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"expected a uint8 or uint16 stream, got "
                        f"{local_flat.dtype}")
    if codec not in ("delta", "xff"):
        raise ValueError(f"codec must be 'delta' or 'xff', got {codec!r}")
    elem_sz = local_flat.dtype.itemsize
    n = total_len
    sl = host_local_elems(n, ndims, mesh.size, mesh.rank, mesh.size)
    lo = sl.start
    if local_flat.size != sl.stop - lo:
        raise ValueError(f"process {mesh.rank} must pass elements [{lo}, "
                         f"{sl.stop}) = {sl.stop - lo} elements, got "
                         f"{local_flat.size}")
    if n < MIN_DATA_SIZE:
        tail = _allgather_window(local_flat, lo, 0, n, mesh)
        return write_metadata_rle(0, n, ndims) + tail.tobytes()
    shard.check_rowmajor(ndims, elem_sz, "mp_compress")
    block_elems = BLOCK_SZ * ndims
    nb_max = n // block_elems
    if nb_max == 0:
        return encoder.compress(_allgather_window(local_flat, lo, 0, n, mesh),
                                ndims, codec, device=mesh.device)
    bpp = -(-nb_max // mesh.size)
    rows = np.zeros((bpp * BLOCK_SZ, ndims), local_flat.dtype)
    nfull = min(sl.stop, nb_max * block_elems) - lo
    nfull -= nfull % block_elems  # the last process's slice has the tail
    if nfull > 0:
        rows.reshape(-1)[:nfull] = local_flat[:nfull]
    enc = shard.encode_shards(
        mesh, shard.upload_shards(mesh, {mesh.rank: rows}), elem_sz, codec)
    return shard.assemble(
        *shard.download_encoded(mesh, enc, elem_sz),
        lambda r: _allgather_window(local_flat, lo, n - r, n, mesh),
        n, ndims, elem_sz, codec, nb_max)


def mp_decompress(buf: bytes, codec: str = "delta", elem_sz: int = 1,
                  mesh: ProcessMesh | None = None) -> np.ndarray:
    """Multi-process decode of a stream every process holds: each process
    walks the headers, decodes its span as a shard (the cross-shard prefix,
    or the FIRE chain, across processes) and gathers the whole array ->
    ``decoder.decompress``'s elements, on every process."""
    return shard.dp_decompress(mesh or global_mesh(), buf, codec, elem_sz)
