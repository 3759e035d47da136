"""Host bitstream packing and unpacking of Rice blocks.

Counterpart of sela_tpu/utils/bitpack.py. Both calls go to the native
library (native/bitio.cpp, built at first use); the port has no numpy packer
to switch to, so a failed build raises.
"""
from __future__ import annotations

import numpy as np

from ..native import bitio


def pack_blocks(blocks: list[tuple[np.ndarray, object]]) -> list[np.ndarray]:
    """[(int32 values, k)] -> [uint32 word arrays], one per block.

    k may be an int (plain block) or a sequence of sub-block ks
    (partitioned residues, FORMAT.md §Partitioned residues)."""
    return bitio.pack_blocks(blocks)


def unpack_blocks(blocks: list[tuple[np.ndarray, int, object]]) -> list[np.ndarray]:
    """[(uint32 words, count, k)] -> [int32 value arrays]."""
    return bitio.unpack_blocks(blocks)
