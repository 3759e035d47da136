"""The least device time a codec on the card could take for a request: its
bytes at the card's memory bandwidth.

A codec whose work is on the device reads every PCM byte and writes every
coded byte (encode), or reads every coded byte and writes every PCM byte
(decode). So PCM bytes + coded bytes is what any such implementation moves
through the device's memory, whatever its kernels, fusion, packing on the
card or choice of pipe. The bound counts no operations: the encoder's LPC
orders are its own output, so an operation count would change with what it
decides.

The share of this bound in the kernels' device time stays under 100% for
the port as it stands because its kernels move at least these bytes: the
encode's read the PCM and write residues no smaller than the code, the
decode's read residues and write the PCM. The port packs and unpacks the
code on the host, so its kernels never touch the coded bytes themselves; a
design that moves more of the work to the host can raise the share with
no kernel getting faster. Read it beside the idle share and the rates.
"""
from __future__ import annotations


def codec_bytes(pcm_bytes: int, coded_bytes: int) -> int:
    """Bytes a request must move: its PCM and its code, each once."""
    return pcm_bytes + coded_bytes


def bound_seconds(nbytes: int, peak_bytes_per_s: float) -> float:
    return nbytes / peak_bytes_per_s
