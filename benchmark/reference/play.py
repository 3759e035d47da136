"""The blocks a player yields from the start of a `.sela` stream, by the
plain numpy decoder (reference/decode.py): the first `frames` frames
decoded, then split one block a frame at the frames' sample counts, each
block [n, C] int32. It imports numpy and the reference only, and raises
the reference's StreamError on a stream the reference refuses."""
from __future__ import annotations

import numpy as np

from .decode import _walk, decode


def played_blocks(buf: bytes, frames: int) -> list[np.ndarray]:
    """The blocks of the first `frames` frames of `buf` (all of them in a
    shorter stream), in stream order."""
    counts = _walk(buf, frames)[1]
    _, _, channels = decode(buf, max_frames=frames)
    pcm = np.stack(channels, axis=1).astype(np.int32)
    return np.split(pcm, np.cumsum(counts)[:-1])
