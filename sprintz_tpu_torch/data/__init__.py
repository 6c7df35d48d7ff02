"""Evaluation corpora: quantizers, binary layout IO, synthetic profiles.

The port's copy of ``sprintz_tpu/data`` (numpy, host; the same exports).
"""

from .corpus import (  # noqa: F401
    CORPUS_PROFILES,
    load_dataset,
    quantize,
    read_dat,
    synthetic_corpus,
    write_dat,
)
