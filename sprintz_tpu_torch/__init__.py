"""sprintz_tpu_torch: the Sprintz codec on PyTorch and CUDA (NVIDIA H100).

A port of ``sprintz_tpu`` that imports neither JAX nor the JAX package.
It covers the delta and FIRE (xff) codecs in both layouts (u8 and u16,
RLE of zero blocks), the +Huf entropy stage, checkpoint sidecars
(``SprintzCodec.compress_seekable``, ``decompress(sidecar=)``,
``checkpoint.decode_range``), batches of streams in one device pass
(``SprintzCodec.compress_batch`` / ``decompress_batch``), query pushdown
(``query.query``) and a file CLI (``python -m sprintz_tpu_torch``); the
kernels are CUDA C++ under ``csrc/``, built with nvcc at first use.
Streams are byte-identical to the reference codec and to the JAX package.

Beside the codec, as in the JAX package: ``search`` (nearest-neighbour
search as one distance matmul and top-k on the card) and ``windows``;
``models.learning`` (the filter-bank search, streamed matmuls on the
card); ``frames`` (DataFrame codec chains, with the ``Sprintz`` column
codec on the card; ``frames.storage`` alone needs pandas); ``data``
(corpora, quantizers, the benchmark file layout); ``utils`` (debug dumps,
host bit helpers, ``timing.device_loop_time``, ``trace``: the profiler
hook ``device_profile``, the codec's spans ``annotate`` and its
``counters``).
"""

from . import query
from .api import Sidecar, SprintzCodec, compress, decompress
from .errors import CorruptStreamError

__all__ = ["CorruptStreamError", "Sidecar", "SprintzCodec", "compress",
           "decompress", "query"]
