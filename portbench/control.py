"""The comparison's control: the frozen reference put in the port's place,
one precision step below what the configuration states. Its ``control``
key names the step: ``fire_coefficient``, FIRE's coefficient kept to its
top ``trunc_bits`` bits (below the full counter of the lowdim layout, or
below the 4 bits the row-major layout keeps).

A run with the control in the port's place must come out not correct:
its streams are not the format's, so ``setup_stream_bytes_wrong`` (decode
mixes) or ``stream_bytes_wrong`` (encode mixes) reads above its limit 0."""

from __future__ import annotations

import numpy as np

from . import reference


class ControlCodec:
    """``compress`` / ``decompress`` of the reference one precision step
    below the configuration's, with the port's call signatures."""

    def __init__(self, config: dict):
        self.codec = config["codec"]
        self.elem_sz = config["elem_sz"]
        ctl = config["control"]
        if ctl["kind"] != "fire_coefficient":
            raise ValueError(f"unknown control {ctl['kind']!r}")
        self.trunc_bits = ctl["trunc_bits"]

    def compress(self, x: np.ndarray) -> bytes:
        return reference.encode(x, self.codec, trunc_bits=self.trunc_bits)

    def decompress(self, buf: bytes) -> np.ndarray:
        return reference.decode(buf, self.codec, self.elem_sz,
                                trunc_bits=self.trunc_bits)
