"""Delta and FIRE forecasters on int32 tensors.

Counterpart of ``sprintz_tpu/models/forecasters.py``.

- Delta is an exact prefix sum: encode is a shifted subtract, decode one
  cumulative sum over rows. The decode path itself runs through the
  kernels of ``ops/decode_kernels.py``; ``delta_decode`` here is the plain
  reference.
- FIRE (``codec="xff"``) is the reference's online linear forecaster
  (``_fire_block_step``, ``forecasters.py:247-300``). ``truncate_coeffs``
  picks its coefficient: the row-major layout's int16 one (True, the
  default) or the lowdim layout's full-precision ``counter >> 1`` (False).
  Its state is serial over blocks and independent across dims.
  ``fire_encode``/``fire_decode`` launch ``csrc/fire.cu``'s
  ``fire_encode_kernel``/``fire_decode_kernel`` for a CUDA tensor: a CTA
  per 32 dims, warp-specialised around a ring of row tiles in shared
  memory (loader warps, one chain warp that runs only the recurrence,
  finisher warps). For a CPU tensor they run ``fire_*_plain``, written
  block-wise on the identities the kernels rest on (below); each wrapper
  counts its launches in ``launches``, and those with the full-precision
  coefficient apart, in ``full_launches``. ``_fire_scan_plain`` is the
  line-by-line port of ``_fire_block_step`` that the tests hold both to.

The identities, all exact in wrapping arithmetic: encode's deltas depend on
the input alone; a block's eight rows are independent given its
coefficient; the gradient sum needs one sign extension
(``sext(sext(a + b) + c) == sext(a + b + c)``); decode's values are the
running sum of its deltas, and its delta needs one sign extension
(``sext(err + sext(p)) == sext(err + p)``). The prediction keeps bits eb
to 2 eb - 1 of ``prev_delta * coef``, so the int64 product here gives the
same bits as JAX's wrapping int32 one, also where the full-precision u16
coefficient (up to 2^30) makes that product wrap.

FIRE's state is the (3, D) int32 carry (prev value, prev delta, learning
counter); ``fire_decode`` takes it as ``init_state`` to enter a stream
mid-way, as the JAX package's ``fire_decode(init_state=...)`` does, and
so does ``fire_encode``. With ``final=True`` either also returns the carry
after its last block, which the same launch writes: the JAX package's
``_fire_scan(init_state=..., return_final=True)``, the state that a
sharded scan hands from one shard to the next (``parallel/shard.py``).
``transform=True`` picks the standalone preprocessor's FIRE (the xff head
of ``transforms.py``; the JAX package's ``_fire_scan(..., learning_shift,
transform=True)``): raw errors in place of zigzag ones, a learning shift of
3 at u16 (1 at u8, the codec's), at u8 the even dims' prediction from the
previous delta's low byte zero-extended, and at u16 the prediction
``sext16(((prev_delta * coef) >> 16) << 2)``. On CUDA it launches the same
two kernels' transform instantiations, counted in ``transform_launches``.
``fire_encode(states=True)`` also returns the carry before every block, in
the same pass (the JAX package's ``fire_encode_with_states`` runs a second
scan for it), and ``fire_decode_chunks`` decodes a stream cut into chunks
of whole blocks, each from its own carry (a checkpoint sidecar's): the
vmapped decode of the JAX package's ``decoder._decode_pass_chunks``, with
C·D lanes where the serial decode has D. Where every chunk's values fit in
shared memory (``fire_short_fits``: a sidecar's default chunks) it launches
``fire_decode_short_kernel``, which stages whole chunks and chains them
there, and counts in ``fire_decode_chunks.short_launches``
(``short_full_launches``); longer chunks take the serial decode's ring
kernel (``launches``, ``full_launches``). The states' encode counts in
``fire_encode.states_launches`` (``states_full_launches``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    BLOCK_SZ,
    FIRE_COUNTER_BITS,
    FIRE_LEARNING_SHIFT,
    FIRE_LOG2_LEARNING_DOWNSAMPLE,
    LOG2_BLOCK_SZ,
    TRANSFORM_LEARNING_SHIFT,
)
from ..ops import _build
from ..ops.bitmath import sign_extend, zigzag_decode, zigzag_encode
from ..ops.decode_kernels import (aligned16, check_args, chunk_args, narrow,
                                  narrow_dtype)


def delta_encode(rows: torch.Tensor, elem_bits: int,
                 prev_row: torch.Tensor | None = None) -> torch.Tensor:
    """rows: (N, D) int32 holding unsigned values -> zigzag errs (N, D) int32.
    ``prev_row``: the (D,) unsigned row before the first (a shard's
    neighbour's last row), zeros when None; it is subtracted before the
    sign extension, as every other row is."""
    first = (torch.zeros_like(rows[:1]) if prev_row is None
             else prev_row.to(rows.device, rows.dtype).reshape(1, -1))
    prev = torch.cat([first, rows[:-1]], dim=0)
    deltas = sign_extend(rows - prev, elem_bits)
    return zigzag_encode(deltas, elem_bits)


def delta_decode(errs_zz: torch.Tensor, elem_bits: int) -> torch.Tensor:
    """Inverse of delta_encode: (N, D) zigzag errs -> values (N, D) int32.

    An integer cumsum in int32; it may wrap, which the eb-bit mask absorbs.
    """
    deltas = zigzag_decode(errs_zz, elem_bits)
    return (torch.cumsum(deltas, dim=0, dtype=torch.int32)
            & ((1 << elem_bits) - 1))


# ------------------------------------------------------------------ FIRE


def _sext(x: torch.Tensor, bits: int) -> torch.Tensor:
    """The low ``bits`` of int64 values, read as signed: JAX's wrapping
    int32 arithmetic followed by its ``sign_extend``, without overflow."""
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def _state_tensor(init_state, device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    """A (3, D) carry given as numpy or torch -> a contiguous tensor."""
    if not torch.is_tensor(init_state):
        init_state = torch.from_numpy(np.array(init_state, dtype=np.int32))
    return init_state.to(device, dtype).contiguous()


def _fire_scan_plain(blocks: torch.Tensor, elem_bits: int, decode: bool,
                     init_state=None, truncate_coeffs: bool = True,
                     transform: bool = False) -> torch.Tensor:
    """FIRE over (nb, 8, D) int64 blocks of values (encode) or zigzag
    errors (decode) -> (nb, 8, D) int64 errors or values: a line-by-line
    port of ``_fire_block_step`` in int64, one block at a time. With
    ``transform``, the preprocessor's variant: its errors are raw, in and
    out, as the JAX package's (sign-extended)."""
    ndims = blocks.shape[2]
    if init_state is None:
        state = torch.zeros((3, ndims), dtype=torch.int64, device=blocks.device)
    else:
        state = _state_tensor(init_state, blocks.device, torch.int64)
    prev_val, prev_delta, counter = state[0], state[1], state[2]
    mask = (1 << elem_bits) - 1
    counter_bits = FIRE_COUNTER_BITS[elem_bits // 8]
    downsample = 1 << FIRE_LOG2_LEARNING_DOWNSAMPLE
    out = torch.empty_like(blocks)
    omask = _operand_mask(ndims, elem_bits, transform, blocks.device)
    for b in range(blocks.shape[0]):
        coef = _fire_coef(counter, elem_bits, truncate_coeffs, transform)
        grad_sum = torch.zeros_like(prev_delta)
        for i in range(BLOCK_SZ):
            prediction = _sext(_predict(prev_delta, coef, elem_bits,
                                        transform, omask), elem_bits)
            x = blocks[b, i]
            if decode:
                err = _sext(x if transform else (x >> 1) ^ -(x & 1),
                            elem_bits)
                delta = _sext(err + prediction, elem_bits)
                val = (prev_val + delta) & mask
                out[b, i] = val
            else:
                val = x
                delta = _sext(val - prev_val, elem_bits)
                err = _sext(delta - prediction, elem_bits)
                out[b, i] = (err if transform
                             else ((err << 1) ^ (err >> 63)) & mask)
            if i % downsample == downsample - 1:
                # icopysign(err, prev_delta) (util.h:63-74)
                grad = torch.where(err != 0,
                                   torch.where(err < 0, -prev_delta,
                                               prev_delta), 0)
                grad_sum = _sext(grad_sum + grad, elem_bits)
            prev_val, prev_delta = val, delta
        counter = _sext(
            counter + (grad_sum >> (LOG2_BLOCK_SZ
                                    - FIRE_LOG2_LEARNING_DOWNSAMPLE)),
            counter_bits)
    return out


def _fire_counter_step(counter: torch.Tensor, err_odd: torch.Tensor,
                       prev_odd: torch.Tensor, elem_bits: int) -> torch.Tensor:
    """The learning counter after a block, from its odd rows' errors and
    the deltas before them ((4, D) each): icopysign(err, prev_delta)
    (util.h:63-74) summed, sign-extended once."""
    grad = (torch.sign(err_odd) * prev_odd).sum(dim=0)
    shift = LOG2_BLOCK_SZ - FIRE_LOG2_LEARNING_DOWNSAMPLE
    return _sext(counter + (_sext(grad, elem_bits) >> shift),
                 FIRE_COUNTER_BITS[elem_bits // 8])


def _fire_coef(counter: torch.Tensor, elem_bits: int,
               truncate_coeffs: bool, transform: bool = False
               ) -> torch.Tensor:
    """The block's coefficient: the int16 of the counter's bits above
    eb - 4 (truncated), or the counter >> 1 in full. ``transform``: the
    preprocessor's learning shift, 3 at u16 (``transforms.py``)."""
    shift = (TRANSFORM_LEARNING_SHIFT[elem_bits // 8] if transform
             else FIRE_LEARNING_SHIFT)
    if not truncate_coeffs:
        return counter >> shift
    shft = elem_bits - 4
    return _sext((counter >> (shift + shft)) << shft, 16)


def _operand_mask(ndims: int, elem_bits: int, transform: bool,
                  device: torch.device) -> torch.Tensor | None:
    """The preprocessor's u8 prediction multiplies the previous delta's low
    byte, zero-extended, in the even dims: a (D,) int64 mask of 0xff there
    and -1 in the odd dims, for ``_predict``; None elsewhere."""
    if not (transform and elem_bits == 8):
        return None
    return torch.where(torch.arange(ndims, device=device) % 2 == 0, 0xFF, -1)


def _predict(prev: torch.Tensor, coef: torch.Tensor, elem_bits: int,
             transform: bool, omask: torch.Tensor | None) -> torch.Tensor:
    """The prediction before its sign extension, from the previous deltas
    ``prev`` (..., D) int64: bits eb and up of ``prev * coef``; with
    ``transform``, the preprocessor's: at u8 ``prev`` masked by ``omask``
    (``_operand_mask``), at u16 the product's bits 16 and up times 4."""
    if omask is not None:
        return ((prev & omask) * coef) >> 8
    if transform:
        return ((prev * coef) >> 16) << 2
    return (prev * coef) >> elem_bits


def _init_carry(init_state, ndims: int, device: torch.device) -> torch.Tensor:
    """The (3, D) int64 carry entering a scan: ``init_state`` or zeros."""
    if init_state is None:
        return torch.zeros((3, ndims), dtype=torch.int64, device=device)
    return _state_tensor(init_state, device, torch.int64)


def _fire_encode_blocks(blocks: torch.Tensor, elem_bits: int,
                        truncate_coeffs: bool, states: bool = False,
                        init_state=None, transform: bool = False):
    """(nb, 8, D) int64 values -> ((nb, 8, D) int64 zigzag errors, with
    ``states`` the (nb, 3, D) int64 carry before each block else None, the
    (3, D) int64 carry after the last block), from ``init_state`` (zeros
    when None). The loop over blocks carries only the counter, through the
    odd rows' errors; everything else is one pass over the stream.
    ``transform``: the preprocessor's FIRE, raw errors masked to eb bits."""
    nb, _, ndims = blocks.shape
    rows = blocks.reshape(-1, ndims)
    init = _init_carry(init_state, ndims, blocks.device)
    deltas = _sext(rows - torch.cat([init[:1], rows[:-1]]), elem_bits)
    prev = torch.cat([init[1:2], deltas[:-1]]).reshape(nb, BLOCK_SZ, ndims)
    deltas = deltas.reshape(nb, BLOCK_SZ, ndims)
    omask = _operand_mask(ndims, elem_bits, transform, blocks.device)
    downsample = 1 << FIRE_LOG2_LEARNING_DOWNSAMPLE
    odd = slice(downsample - 1, None, downsample)
    coefs = torch.empty((nb, 1, ndims), dtype=torch.int64,
                        device=blocks.device)
    counter = init[2]
    counters = torch.empty((nb, ndims), dtype=torch.int64,
                           device=blocks.device)
    for b in range(nb):
        counters[b] = counter
        coef = coefs[b, 0] = _fire_coef(counter, elem_bits, truncate_coeffs,
                                        transform)
        prev_odd = prev[b, odd]
        err_odd = _sext(deltas[b, odd]
                        - _predict(prev_odd, coef, elem_bits, transform,
                                   omask), elem_bits)
        counter = _fire_counter_step(counter, err_odd, prev_odd, elem_bits)
    errs = _sext(deltas - _predict(prev, coefs, elem_bits, transform, omask),
                 elem_bits)
    zz = (errs if transform else (errs << 1) ^ (errs >> 63)) & (
        (1 << elem_bits) - 1)
    final = (torch.stack([rows[-1], deltas[-1, -1], counter]) if nb
             else init)
    if not states:
        return zz, None, final
    # the carry before block b: the value and the delta of the row above
    # it (the carried ones above the first), and the counter
    above = torch.cat([init[:1], rows[BLOCK_SZ - 1:-1:BLOCK_SZ]])
    return zz, torch.stack([above, prev[:, 0], counters], dim=1), final


def _fire_decode_blocks(blocks: torch.Tensor, elem_bits: int,
                        init_state, truncate_coeffs: bool,
                        final: bool = False, transform: bool = False):
    """(nb, 8, D) int64 zigzag errors -> (nb, 8, D) int64 values, and with
    ``final`` the (3, D) int64 carry after the last block. The loop over
    rows carries only the delta, and the one over blocks the counter; the
    zigzag decode runs before them and the values are a cumulative sum
    after them. ``transform``: the preprocessor's FIRE, raw errors. A
    block's rows are kept as a list of tensors and stacked once, so that a
    row costs only its arithmetic's launches on a card."""
    nb, _, ndims = blocks.shape
    state = _init_carry(init_state, ndims, blocks.device)
    prev_val, prev_delta, counter = state[0], state[1], state[2]
    errs = _sext(blocks if transform else (blocks >> 1) ^ -(blocks & 1),
                 elem_bits)
    omask = _operand_mask(ndims, elem_bits, transform, blocks.device)
    downsample = 1 << FIRE_LOG2_LEARNING_DOWNSAMPLE
    odd = slice(downsample - 1, None, downsample)
    deltas = torch.empty_like(errs)
    for b in range(nb):
        coef = _fire_coef(counter, elem_bits, truncate_coeffs, transform)
        rows = [prev_delta]  # the delta above each row, then the last row's
        for i in range(BLOCK_SZ):
            rows.append(_sext(errs[b, i] + _predict(
                rows[-1], coef, elem_bits, transform, omask), elem_bits))
        prev_delta = rows[-1]
        deltas[b] = torch.stack(rows[1:])
        counter = _fire_counter_step(counter, errs[b, odd],
                                     torch.stack(rows[:-1][odd]), elem_bits)
    vals = ((prev_val + torch.cumsum(deltas.reshape(-1, ndims), dim=0))
            & ((1 << elem_bits) - 1))
    if not final:
        return vals.reshape(blocks.shape)
    carry = (torch.stack([vals[-1], prev_delta, counter]) if nb else state)
    return vals.reshape(blocks.shape), carry


def _check_fire(name: str, x: torch.Tensor, elem_bits: int,
                dtype: torch.dtype) -> None:
    narrow_dtype(elem_bits)  # raises unless 8 or 16
    check_args(name, x.device, x=(x, dtype))
    if x.dim() != 2 or x.shape[0] % BLOCK_SZ:
        raise ValueError(f"{name}: input {tuple(x.shape)} is not (N, D) with "
                         f"N a multiple of {BLOCK_SZ}")


# csrc/fire.cu's sprintz_fire_scan mode of the preprocessor's FIRE (its
# other modes are the truncated coefficient, 1, and the full one, 0)
MODE_TRANSFORM = 2


def _count_launch(wrapper, truncate_coeffs: bool, kind: str = "") -> None:
    attr = kind + ("launches" if truncate_coeffs else "full_launches")
    setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def _outputs(out, carries, fin, states: bool, final: bool):
    """A scan's result as its caller asked for it: out, then the carries
    before each block with ``states``, then the final carry with
    ``final``."""
    if not (states or final):
        return out
    return (out,) + ((carries,) if states else ()) + ((fin,) if final else ())


def _check_init(name: str, init_state, ndims: int) -> None:
    if init_state is not None and tuple(np.shape(init_state)) != (3, ndims):
        raise ValueError(f"{name}: init_state {tuple(np.shape(init_state))}"
                         f" is not (3, {ndims})")


def _check_transform(name: str, transform: bool, truncate_coeffs: bool,
                     *unsupported) -> None:
    """The preprocessor's FIRE runs from the zero state with the
    truncated coefficient alone (the JAX package's ``transforms.py``)."""
    if transform and (not truncate_coeffs or any(unsupported)):
        raise ValueError(f"{name}: transform=True takes the truncated "
                         f"coefficient and no states, init_state or final")


def fire_encode_plain(rows: torch.Tensor, elem_bits: int,
                      truncate_coeffs: bool = True, states: bool = False,
                      init_state=None, final: bool = False,
                      transform: bool = False):
    """Plain version of ``fire_encode``."""
    _check_transform("fire_encode", transform, truncate_coeffs, states,
                     init_state is not None, final)
    n, ndims = rows.shape
    if rows.numel() == 0:
        errs = rows.to(torch.int32)
        fin = _init_carry(init_state, ndims, rows.device).to(torch.int32)
        return _outputs(errs, errs.new_zeros((0, 3, ndims)), fin, states,
                        final)
    zz, carries, fin = _fire_encode_blocks(
        rows.to(torch.int64).reshape(-1, BLOCK_SZ, ndims), elem_bits,
        truncate_coeffs, states, init_state, transform)
    return _outputs(zz.reshape(n, ndims).to(torch.int32),
                    None if carries is None else carries.to(torch.int32),
                    fin.to(torch.int32), states, final)


def fire_encode(rows: torch.Tensor, elem_bits: int,
                truncate_coeffs: bool = True, states: bool = False,
                init_state=None, final: bool = False,
                transform: bool = False):
    """rows (N, D) int32 unsigned values, N a multiple of 8 -> zigzag
    errors (N, D) int32. ``truncate_coeffs``: the row-major layout's int16
    coefficient (True) or the lowdim layout's full-precision one (False).
    ``init_state``: optional (3, D) int32 carry entering the first block
    (prev value, prev delta, counter), numpy or torch; the zero state when
    None. With ``states``, also returns carries (N / 8, 3, D) int32, the
    state before each block, written by the same launch (on CUDA a view of
    (N / 8, D, 4) words, one a block and dim); with ``final``, also the
    (3, D) int32 carry after the last block (``init_state`` or zeros when
    N is 0), in that order: (errors[, carries][, final]). With
    ``transform``, the preprocessor's FIRE from the zero state: its raw
    errors masked to elem_bits bits, (N, D) int32 (no states, init_state
    or final; the truncated coefficient)."""
    _check_fire("fire_encode", rows, elem_bits, torch.int32)
    n, ndims = rows.shape
    _check_init("fire_encode", init_state, ndims)
    _check_transform("fire_encode", transform, truncate_coeffs, states,
                     init_state is not None, final)
    if rows.device.type == "cpu":
        return fire_encode_plain(rows, elem_bits, truncate_coeffs, states,
                                 init_state, final, transform)
    errs = torch.empty_like(rows)
    # the kernel writes a carry as one 16-byte word (its 4th int unused):
    # the (nb, 3, D) carries are a view of (nb, D, 4)
    words = (torch.empty((n // BLOCK_SZ, ndims, 4), dtype=torch.int32,
                         device=rows.device) if states else None)
    carries = None if words is None else words[..., :3].transpose(1, 2)
    init = (None if init_state is None
            else _state_tensor(init_state, rows.device, torch.int32))
    if n == 0 or ndims == 0:
        fin = (init if init is not None else torch.zeros(
            (3, ndims), dtype=torch.int32, device=rows.device))
        return _outputs(errs, carries, fin, states, final)
    fin = (torch.empty((3, ndims), dtype=torch.int32, device=rows.device)
           if final else None)
    _build.launch("sprintz_fire_scan", rows, rows.data_ptr(),
                  None if init is None else init.data_ptr(),
                  None if fin is None else fin.data_ptr(),
                  None if words is None else words.data_ptr(),
                  errs.data_ptr(), n // BLOCK_SZ, ndims, elem_bits, 0,
                  MODE_TRANSFORM if transform else int(truncate_coeffs))
    if transform:
        fire_encode.transform_launches += 1
    elif states:
        _count_launch(fire_encode, truncate_coeffs, "states_")
    else:
        _count_launch(fire_encode, truncate_coeffs)
    return _outputs(errs, carries, fin, states, final)


fire_encode.launches = 0
fire_encode.full_launches = 0
fire_encode.states_launches = 0
fire_encode.states_full_launches = 0
fire_encode.transform_launches = 0


def fire_decode_plain(errs_zz: torch.Tensor, elem_bits: int,
                      init_state=None, truncate_coeffs: bool = True,
                      final: bool = False, transform: bool = False):
    """Plain version of ``fire_decode``."""
    _check_transform("fire_decode", transform, truncate_coeffs,
                     init_state is not None, final)
    n, ndims = errs_zz.shape
    if errs_zz.numel() == 0:
        vals = narrow(errs_zz.to(torch.int32), elem_bits)
        fin = _init_carry(init_state, ndims, errs_zz.device).to(torch.int32)
        return (vals, fin) if final else vals
    out = _fire_decode_blocks(
        errs_zz.to(torch.int64).reshape(-1, BLOCK_SZ, ndims), elem_bits,
        init_state, truncate_coeffs, final, transform)
    vals, fin = out if final else (out, None)
    vals = narrow(vals.reshape(n, ndims).to(torch.int32), elem_bits)
    return (vals, fin.to(torch.int32)) if final else vals


def fire_decode(errs_zz: torch.Tensor, elem_bits: int, init_state=None,
                truncate_coeffs: bool = True, final: bool = False,
                transform: bool = False):
    """Zigzag errors (N, D), N a multiple of 8 -> values (N, D) u8/u16.

    The errors are uint8 at elem_bits 8 (``unpack_rows(narrow=True)``) and
    int32 at 16. ``init_state``: optional (3, D) int32 carry entering the
    first block (prev value, prev delta, counter), numpy or torch; the
    zero state when None. ``truncate_coeffs`` as in ``fire_encode``. With
    ``final``, returns (values, the (3, D) int32 carry after the last
    block), from the same launch.

    ``transform``: the preprocessor's FIRE from the zero state; the errors
    are its raw ones as stored, uint8 at elem_bits 8 and u16 as int16 at
    16 (no init_state or final; the truncated coefficient).
    """
    _check_fire("fire_decode", errs_zz, elem_bits,
                (torch.uint8 if elem_bits == 8 else torch.int16) if transform
                else torch.uint8 if elem_bits == 8 else torch.int32)
    n, ndims = errs_zz.shape
    _check_init("fire_decode", init_state, ndims)
    _check_transform("fire_decode", transform, truncate_coeffs,
                     init_state is not None, final)
    if errs_zz.device.type == "cpu":
        return fire_decode_plain(errs_zz, elem_bits, init_state,
                                 truncate_coeffs, final, transform)
    vals = torch.empty((n, ndims), dtype=narrow_dtype(elem_bits),
                       device=errs_zz.device)
    state = (None if init_state is None
             else _state_tensor(init_state, errs_zz.device, torch.int32))
    if n == 0 or ndims == 0:
        fin = (state if state is not None else torch.zeros(
            (3, ndims), dtype=torch.int32, device=errs_zz.device))
        return (vals, fin) if final else vals
    fin = (torch.empty((3, ndims), dtype=torch.int32, device=errs_zz.device)
           if final else None)
    _build.launch("sprintz_fire_scan", errs_zz, errs_zz.data_ptr(),
                  None if state is None else state.data_ptr(),
                  None if fin is None else fin.data_ptr(), None,
                  vals.data_ptr(), n // BLOCK_SZ, ndims, elem_bits, 1,
                  MODE_TRANSFORM if transform else int(truncate_coeffs))
    if transform:
        fire_decode.transform_launches += 1
    else:
        _count_launch(fire_decode, truncate_coeffs)
    return (vals, fin) if final else vals


fire_decode.launches = 0
fire_decode.full_launches = 0
fire_decode.transform_launches = 0


# csrc/fire.cu's SHORT_MAX_DIMS and SHORT_CHUNK_BYTES: the short-chunk
# decode takes chunks of at most this many values' bytes and dims
SHORT_MAX_DIMS = 256
SHORT_CHUNK_BYTES = 48 * 1024


def fire_short_fits(most_blocks: int, ndims: int, elem_bits: int) -> bool:
    """Whether a chunked decode whose longest chunk has ``most_blocks``
    blocks goes to the short-chunk kernel (else the ring kernel)."""
    return (ndims <= SHORT_MAX_DIMS and most_blocks * BLOCK_SZ * ndims
            * (elem_bits // 8) <= SHORT_CHUNK_BYTES)


def fire_decode_chunks_plain(errs_zz: torch.Tensor, elem_bits: int,
                             chunk_first_block, states,
                             truncate_coeffs: bool = True) -> torch.Tensor:
    """Plain version of ``fire_decode_chunks``: one loop over the blocks of
    the longest chunk with all C·D lanes at once, each chunk's blocks
    padded with zero errors past its end."""
    n, ndims = errs_zz.shape
    ck = chunk_args("fire_decode_chunks", chunk_first_block, states,
                    n // BLOCK_SZ, (3, ndims), errs_zz.device)
    first, st = ck.first, ck.states.to(torch.int64)
    nchunks = first.size - 1
    lens = np.diff(first)
    longest = int(lens.max())
    if longest == 0 or ndims == 0:
        return narrow(errs_zz.to(torch.int32), elem_bits)
    dev = errs_zz.device
    blk = (torch.from_numpy(first[:-1]).to(dev)[:, None]
           + torch.arange(longest, device=dev)[None, :])  # (C, L)
    live = torch.arange(longest, device=dev)[None, :] < torch.from_numpy(
        lens).to(dev)[:, None]
    errs = errs_zz.to(torch.int64).reshape(-1, BLOCK_SZ, ndims)
    errs = torch.cat([errs, errs.new_zeros((1, BLOCK_SZ, ndims))])
    lanes = errs[torch.where(live, blk, n // BLOCK_SZ)]  # (C, L, 8, D)
    lanes = lanes.permute(1, 2, 0, 3).reshape(longest, BLOCK_SZ,
                                              nchunks * ndims)
    vals = _fire_decode_blocks(lanes, elem_bits,
                               st.permute(1, 0, 2).reshape(3, -1),
                               truncate_coeffs)
    vals = vals.reshape(longest, BLOCK_SZ, nchunks, ndims).permute(2, 0, 1, 3)
    out = torch.empty((n // BLOCK_SZ, BLOCK_SZ, ndims), dtype=torch.int64,
                      device=dev)
    out[blk[live]] = vals[live]
    return narrow(out.reshape(n, ndims).to(torch.int32), elem_bits)


def fire_decode_chunks(errs_zz: torch.Tensor, elem_bits: int,
                       chunk_first_block, states,
                       truncate_coeffs: bool = True) -> torch.Tensor:
    """Zigzag errors (N, D) as ``fire_decode`` takes them -> values (N, D)
    u8/u16, the stream cut into C chunks of whole blocks: chunk c is blocks
    ``chunk_first_block[c]`` to ``chunk_first_block[c + 1]`` (C + 1 block
    indices from 0 to N / 8, on the host) and decodes from ``states[c]``,
    its (3, D) carry (``states`` (C, 3, D) int32, numpy or torch), as
    the JAX package's chunk-parallel decode does from a sidecar. With the
    sidecar's states equal to the stream's carries the values are
    ``fire_decode``'s; with other states each chunk follows its own. On
    CUDA the chunk starts and numpy states go up in one pinned copy, and
    the longest chunk picks the kernel (``fire_short_fits``)."""
    _check_fire("fire_decode_chunks", errs_zz, elem_bits,
                torch.uint8 if elem_bits == 8 else torch.int32)
    n, ndims = errs_zz.shape
    if errs_zz.device.type == "cpu":
        return fire_decode_chunks_plain(errs_zz, elem_bits, chunk_first_block,
                                        states, truncate_coeffs)
    ck = chunk_args("fire_decode_chunks", chunk_first_block, states,
                    n // BLOCK_SZ, (3, ndims), errs_zz.device)
    nchunks = ck.first.size - 1
    vals = torch.empty((n, ndims), dtype=narrow_dtype(elem_bits),
                       device=errs_zz.device)
    if n == 0 or ndims == 0:
        return vals
    most = int(np.diff(ck.first).max())
    if fire_short_fits(most, ndims, elem_bits):
        errs_zz = aligned16(errs_zz)
        _build.launch("sprintz_fire_decode_short", errs_zz, errs_zz.data_ptr(),
                      ck.states.data_ptr(), ck.first_d.data_ptr(), nchunks,
                      most, vals.data_ptr(), n // BLOCK_SZ, ndims, elem_bits,
                      int(truncate_coeffs))
        _count_launch(fire_decode_chunks, truncate_coeffs, "short_")
    else:
        _build.launch("sprintz_fire_decode_chunks", errs_zz,
                      errs_zz.data_ptr(), ck.states.data_ptr(),
                      ck.first_d.data_ptr(), nchunks, vals.data_ptr(),
                      n // BLOCK_SZ, ndims, elem_bits, int(truncate_coeffs))
        _count_launch(fire_decode_chunks, truncate_coeffs)
    return vals


fire_decode_chunks.launches = 0
fire_decode_chunks.full_launches = 0
fire_decode_chunks.short_launches = 0
fire_decode_chunks.short_full_launches = 0
