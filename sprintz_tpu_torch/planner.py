"""Emission planner: derive the group/RLE stream structure from zero flags.

The reference encoder interleaves run-length control flow with byte
emission (gotos at sprintz_delta_rle.cpp:214-312). The forecaster state
evolves identically for every block read, regardless of grouping, so the
per-block errors and widths are computed in parallel on the device and the
stream structure reduces to a host scan over per-block zero flags. The
planner emits a flat sequence of SLOT events (two slots per group):

  kind 0 (data): block payload at the slot
  kind 1 (run):  a run-length varint closing a zero run
  kind 2 (run0): a zero byte padding out the final group at end of data

The "group respawn" case (sprintz_delta_rle.cpp:287-303) needs no special
handling: slots are sequential and group g owns slots 2g and 2g+1.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import native_host
from .constants import BLOCK_SZ, GROUP_SZ_BLOCKS, MAX_RUN_NBLOCKS
from .utils.trace import annotate

KIND_DATA = 0
KIND_RUN = 1
KIND_RUN0 = 2


@dataclasses.dataclass
class EmissionPlan:
    kinds: np.ndarray  # (nslots,) int8
    values: np.ndarray  # (nslots,) int32: block idx (data) or run length
    ngroups: int
    consumed_blocks: int  # blocks consumed from the input
    remaining_elems: int  # trailing verbatim elements

    @property
    def nslots(self) -> int:
        return len(self.kinds)


@annotate("encode.plan")
def build_plan(
    zero_flags: np.ndarray,
    n_elems: int,
    ndims: int,
    run_cmp_allows_equal: bool = False,
) -> EmissionPlan:
    """Replicates the reference encoder's consumption order over zero flags,
    in the port's host library (``native_host.build_plan``);
    ``_build_plan_py`` is its plain version.

    ``zero_flags[b]`` is True iff block b's zigzagged errors are all zero.
    A run continues while the next block starts before the last full
    group's start: delta's comparator is a strict ``<``
    (sprintz_delta_rle.cpp:226); row-major FIRE's allows equality
    (``run_cmp_allows_equal=True``, the JAX package's ``encoder.py:346``).
    """
    kinds, values, ngroups, consumed, remaining = native_host.build_plan(
        zero_flags, n_elems, ndims, run_cmp_allows_equal)
    return EmissionPlan(kinds=kinds, values=values, ngroups=ngroups,
                        consumed_blocks=consumed, remaining_elems=remaining)


def _build_plan_py(
    zero_flags: np.ndarray,
    n_elems: int,
    ndims: int,
    run_cmp_allows_equal: bool = False,
) -> EmissionPlan:
    """``build_plan``'s plain version: a Python loop over the blocks."""
    block_elems = BLOCK_SZ * ndims
    group_sz = block_elems * GROUP_SZ_BLOCKS
    last_start = n_elems - group_sz

    kinds: list[int] = []
    values: list[int] = []
    i = 0
    run = 0
    finished = False

    while i <= last_start and not finished:
        b = 0
        while b < GROUP_SZ_BLOCKS:
            bidx = i // block_elems
            z = bool(zero_flags[bidx])
            while True:  # just_read_block
                if z and run < MAX_RUN_NBLOCKS:
                    run += 1
                    i += block_elems
                    if i < last_start or (run_cmp_allows_equal
                                          and i == last_start):
                        break
                    kinds.append(KIND_RUN)
                    values.append(run)
                    run = 0
                    b += 1
                    while b < GROUP_SZ_BLOCKS:
                        kinds.append(KIND_RUN0)
                        values.append(0)
                        b += 1
                    finished = True
                    break
                if run > 0:
                    kinds.append(KIND_RUN)
                    values.append(run)
                    run = 0
                    b += 1
                    if b == GROUP_SZ_BLOCKS:
                        b = 0
                        continue  # same block re-enters as next group's first
                    if z:
                        continue  # run cap hit on a zero block
                kinds.append(KIND_DATA)
                values.append(bidx)
                i += block_elems
                b += 1
                break
            if finished:
                break

    nslots = len(kinds)
    assert nslots % GROUP_SZ_BLOCKS == 0
    return EmissionPlan(
        kinds=np.asarray(kinds, dtype=np.int8),
        values=np.asarray(values, dtype=np.int32),
        ngroups=nslots // GROUP_SZ_BLOCKS,
        consumed_blocks=i // block_elems,
        remaining_elems=n_elems - i,
    )


def pack_headers(slot_headers: np.ndarray, hdr_bits: int) -> np.ndarray:
    """Pack per-slot header fields into per-group header bytes.

    slot_headers: (nslots, ndims) uint8 stored width fields.
    Returns (ngroups, total_header_bytes) uint8, LSB-first bit order within
    bytes (the reference's little-endian OR-writes,
    sprintz_delta_rle.cpp:315-334).
    """
    nslots, ndims = slot_headers.shape
    ngroups = nslots // GROUP_SZ_BLOCKS
    fields = slot_headers.reshape(ngroups, GROUP_SZ_BLOCKS * ndims)
    bits = (fields[:, :, None] >> np.arange(hdr_bits)[None, None, :]) & 1
    bits = bits.reshape(ngroups, GROUP_SZ_BLOCKS * ndims * hdr_bits)
    pad = (-bits.shape[1]) % 8
    if pad:
        bits = np.pad(bits, ((0, 0), (0, pad)))
    return np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")


def unpack_headers(
    header_bytes: np.ndarray, ngroups: int, ndims: int, hdr_bits: int
) -> np.ndarray:
    """Inverse of pack_headers: (ngroups, hdr_nbytes) -> (nslots, ndims)."""
    bits = np.unpackbits(header_bytes, axis=1, bitorder="little")
    nfields = GROUP_SZ_BLOCKS * ndims
    bits = bits[:, : nfields * hdr_bits].reshape(ngroups, nfields, hdr_bits)
    fields = (bits << np.arange(hdr_bits)[None, None, :]).sum(axis=2)
    return fields.reshape(ngroups * GROUP_SZ_BLOCKS, ndims).astype(np.uint8)
