"""The comparison that decides ``correct``: what the timed path returned
against the frozen reference (``portbench/reference``), which works from
the generated arrays alone. Each mix's entry (``entries/<entry>.py``)
says what it compares; this module holds what they share.

Every number compared is a count of things that differ, with the limit 0:
the codec is lossless and its streams are the reference format's, byte for
byte."""

from __future__ import annotations

import importlib

import numpy as np

from . import reference


def bytes_wrong(got, want: bytes) -> int:
    """Bytes that differ, a length's difference counted in full; an answer
    that is no bytes counts as all wrong."""
    if not isinstance(got, (bytes, bytearray)):
        return len(want)
    a = np.frombuffer(got, np.uint8)
    b = np.frombuffer(want, np.uint8)
    m = min(a.size, b.size)
    return int(np.count_nonzero(a[:m] != b[:m])) + abs(a.size - b.size)


def values_wrong(got, want: np.ndarray) -> int:
    """Elements that differ, a length's difference counted in full; an
    answer of another type counts as all wrong."""
    want = want.reshape(-1)
    if not isinstance(got, np.ndarray) or got.dtype != want.dtype:
        return want.size
    got = got.reshape(-1)
    m = min(got.size, want.size)
    return int(np.count_nonzero(got[:m] != want[:m])) + abs(
        got.size - want.size)


def reference_streams(config: dict, inputs: list[np.ndarray]) -> list[bytes]:
    """The reference's stream of each input. A configuration with an
    entropy stage takes the encoder of ``reference/<entropy>.py``, which a
    later benchmark adds with the stage's first cell."""
    if config["entropy"] == "none":
        encode = reference.encode
    else:
        try:
            encode = importlib.import_module(
                f".reference.{config['entropy']}", __package__).encode
        except ImportError as exc:
            raise ValueError(f"no reference for the entropy stage "
                             f"{config['entropy']!r}") from exc
    return [encode(x, config["codec"]) for x in inputs]


def compare(mix, config: dict, inputs: list[np.ndarray], prepared,
            window) -> list[tuple]:
    """-> [(name, value, limit), ...]: the numbers compared, each with its
    limit: the window's failed calls, then the entry's own."""
    return [("failed_calls", window.failed, 0)] + mix.entry.compare(
        config, inputs, prepared, window)
