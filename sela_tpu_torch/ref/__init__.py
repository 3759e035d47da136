"""`sela_tpu_torch.ref` — the port's copy of the pure-numpy oracle.

This package is the executable form of FORMAT.md: scalar-clear, sequential,
and normative. The port's decoder uses its container parser and validation,
and its encoder is the only encoder the port has until the encode slice.
"""
from . import codec, container, frame, lpc, rice, wav  # noqa: F401
from .codec import decode_sela, encode_wav  # noqa: F401
from .wav import WavData, read_wav, read_wav_bytes, write_wav, write_wav_bytes  # noqa: F401
