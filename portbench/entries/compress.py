"""``codec.compress`` of the inputs. Set-up compresses each once for the
stream sizes. The comparison: the sampled calls' streams against the
reference's (``stream_bytes_wrong``)."""

from __future__ import annotations

from portbench import check
from portbench.loop import Prepared

KEYS = ()  # no keys besides every mix's


def prepare(codec, inputs) -> Prepared:
    return Prepared(codec.compress, list(inputs),
                    [len(codec.compress(x)) for x in inputs])


def compare(config, inputs, prepared, window) -> list[tuple]:
    want = check.reference_streams(config, inputs)
    return [("stream_bytes_wrong",
             sum(check.bytes_wrong(out, want[window.inputs_used[i]])
                 for i, out in window.kept.items()), 0)]
