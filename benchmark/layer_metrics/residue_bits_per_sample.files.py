"""residue_bits_per_sample.files: the bits of Rice-coded residue words in
encode_files' streams, per sample and channel: the share of the code that
the device step's choice of LPC order and Rice parameters (K5, K6) decides.
Read from the subframe headers of the streams of the first kept request of
each batch (the reference's walk of the container). Moves ratio."""
from benchmark.reference.decode import _walk


def read(ctx):
    if ctx.op != "encode_files":
        return None
    first = {}
    for r in ctx.records:
        if r.get("out") is not None:
            first.setdefault(r["track"], r["out"])
    bits = samples = 0
    for buf in (b for bufs in first.values() for b in bufs):
        (_, _, channels, _), n, _, _, words, _, _ = _walk(buf, None)
        bits += 32 * int(words.sum())
        samples += int(n.sum()) * channels
    return bits / samples if samples else None
