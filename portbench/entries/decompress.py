"""``codec.decompress`` of streams that set-up compresses with the port
from the inputs. The comparison: set-up's streams against the reference's
(``setup_stream_bytes_wrong``), and the sampled calls' values against the
inputs (``values_wrong``)."""

from __future__ import annotations

from portbench import check
from portbench.loop import Prepared

KEYS = ()  # no keys besides every mix's


def prepare(codec, inputs) -> Prepared:
    streams = [codec.compress(x) for x in inputs]
    return Prepared(codec.decompress, streams, [len(s) for s in streams],
                    state=streams)


def compare(config, inputs, prepared, window) -> list[tuple]:
    want = check.reference_streams(config, inputs)
    return [("setup_stream_bytes_wrong",
             sum(check.bytes_wrong(g, w)
                 for g, w in zip(prepared.state, want)), 0),
            ("values_wrong",
             sum(check.values_wrong(out, inputs[window.inputs_used[i]])
                 for i, out in window.kept.items()), 0)]
