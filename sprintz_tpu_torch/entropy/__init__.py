"""The +Huf entropy stage: chunked canonical Huffman coding."""

from .huffman import (  # noqa: F401
    HuffmanTable,
    build_table,
    huff_compress,
    huff_decompress,
    is_container,
)
