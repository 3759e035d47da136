"""residue_bits_per_sample.encode: the bits of Rice-coded residue words in
the window's streams, per sample and channel: the share of the code that
the device step's choice of LPC order and Rice parameters (K5, K6, K8)
decides, the rest being the frames' and subframes' headers and the
quantised coefficients. Read from the subframe headers of the first kept
stream of each track (the reference's walk of the container). Moves
ratio."""
from benchmark.reference.decode import _walk


def read(ctx):
    if ctx.op != "encode":
        return None
    first = {}
    for r in ctx.records:
        if r.get("out") is not None:
            first.setdefault(r["track"], r["out"])
    bits = samples = 0
    for buf in first.values():
        (_, _, channels, _), n, _, _, words, _, _ = _walk(buf, None)
        bits += 32 * int(words.sum())
        samples += int(n.sum()) * channels
    return bits / samples if samples else None
