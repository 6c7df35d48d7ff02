"""Faults planted under the timed path, each of which a run must come out
not correct on: the comparison's own test (``tests/test_portbench_harness.py``)
and, at a cell's own size on the card, ``probes/control.py --fault``.

Each builder takes the mix's side ("decode" or "encode") and returns
(module, attribute, replacement) for the port's function it breaks,
where its caller looks it up."""

from __future__ import annotations


def frozen_state(side):
    """FIRE whose learning state never moves: its coefficient stays 0, a
    delta forecast."""
    import torch
    from sprintz_tpu_torch.models import forecasters

    if side == "encode":
        def fire_encode(rows, elem_bits, **kw):
            return forecasters.delta_encode(rows, elem_bits)
        return "sprintz_tpu_torch.encoder", "fire_encode", fire_encode
    original = forecasters.fire_decode

    def fire_decode(errs, elem_bits, **kw):
        like = original(errs, elem_bits, **kw)
        return forecasters.delta_decode(errs.to(torch.int32),
                                        elem_bits).to(like.dtype)
    return "sprintz_tpu_torch.decoder", "fire_decode", fire_decode


def half_left_out(side):
    """Half of each answer left out."""
    from sprintz_tpu_torch import decoder, encoder

    if side == "encode":
        original = encoder.assemble_stream

        def assemble_stream(*args, **kw):
            out = original(*args, **kw)
            stream = out[0] if isinstance(out, tuple) else out
            half = stream[:len(stream) // 2]
            return (half,) + out[1:] if isinstance(out, tuple) else half
        return "sprintz_tpu_torch.encoder", "assemble_stream", assemble_stream
    original = decoder.download_values

    def download_values(vals):
        out = original(vals)
        return out[:out.size // 2]
    return "sprintz_tpu_torch.decoder", "download_values", download_values


def answer_altered(side):
    """One value, or one byte, altered where it is produced."""
    from sprintz_tpu_torch import decoder, encoder

    if side == "encode":
        original = encoder.assemble_stream

        def assemble_stream(*args, **kw):
            out = original(*args, **kw)
            stream = bytearray(out[0] if isinstance(out, tuple) else out)
            stream[len(stream) // 3] ^= 0x10
            stream = bytes(stream)
            return (stream,) + out[1:] if isinstance(out, tuple) else stream
        return "sprintz_tpu_torch.encoder", "assemble_stream", assemble_stream
    original = decoder.download_values

    def download_values(vals):
        out = original(vals).copy()
        out[out.size // 3] ^= 1
        return out
    return "sprintz_tpu_torch.decoder", "download_values", download_values


FAULTS = {f.__name__: f for f in (frozen_state, half_left_out,
                                  answer_altered)}
