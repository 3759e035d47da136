"""decode: `decode_sela` of the pool's streams, one after another.

Set-up encodes each pool track once with the program's `encode_wav` under
the cell's profile (traffic.encode_pool), at its default `chunk_frames`;
request i decodes the stream of track `t.track(i)` with the program's
`decode_sela`, at its default `chunk_frames`.

Record: `track`; `coded` (the stream's bytes); `encoded_pcm` (the PCM
bytes the stream holds, at its depth), which `ratio` and the harness's
`stretch_bytes` read (a decode cell never joins `encode_MBps`'s list,
which reads the same key); `decoded_pcm` (the PCM bytes the request
returned, at its header's depth); `counters` (the request's program
counters, where a sink was passed, else None); `out` (the decoded WavData
where kept, else None). Each distinct output is held once, so the kept
outputs of a correct run are two, one a track, whatever the window's
length.

Checks, once the window has closed, each limit 0: every distinct kept
output against its track's PCM (`mismatched_samples`), its rate, depth
and channel count against the configuration's (`header_mismatches`),
every request's decoded PCM bytes against the stream's (`size_mismatches`),
and the pool's streams decoded by the plain reference against the PCM
(`stream_mismatches`, `undecodable_streams`), so that a bad stream the
program happens to decode back is still caught. Control: the program's
`decode_sela` with the lowest bit of every output sample cleared (a
lossy decoder)."""
from __future__ import annotations

from types import SimpleNamespace

from benchmark.traffic import (encode_pool, mismatch, pcm_bytes,
                               reference_checks)


def _decode_sela():
    from sela_tpu_torch.codec import decoder   # looked up at call time

    return decoder.decode_sela


def setup(t):
    """The pool's streams, and each track's distinct outputs held."""
    return SimpleNamespace(streams=encode_pool(t),
                           held={k: [] for k in range(len(t.pool))})


def _header(w) -> tuple:
    return w.sample_rate, w.bits_per_sample, w.n_channels


def _hold(t, track: int, w):
    """`w`, or the output held for `track` that equals it."""
    held = t.state.held[track]
    for h in held:
        if _header(h) == _header(w) and not mismatch(h.channels, w.channels):
            return h
    held.append(w)
    return w


def request(t, i, metrics):
    track = t.track(i)
    buf = t.state.streams[track]
    before = dict(metrics.counters) if metrics is not None else None
    w = _decode_sela()(buf, device=t.device, metrics=metrics)
    counters = None if metrics is None else {
        k: v - before.get(k, 0) for k, v in metrics.counters.items()}
    return dict(track=track, coded=len(buf), encoded_pcm=pcm_bytes(t.cfg),
                decoded_pcm=w.n_samples * w.n_channels * w.bits_per_sample
                // 8, counters=counters,
                out=_hold(t, track, w) if t.kept(i) else None)


def checks(t, records):
    outs = {}   # id -> (track, the distinct kept output)
    for r in records:
        if r["out"] is not None:
            outs.setdefault(id(r["out"]), (r["track"], r["out"]))
    cfg = t.cfg
    want = cfg["sample_rate"], cfg["bits_per_sample"], cfg["channels"]
    bad = sum(mismatch(t.pool[k].channels, w.channels)
              for k, w in outs.values())
    headers = sum(_header(w) != want for _, w in outs.values())
    sizes = sum(r["decoded_pcm"] != r["encoded_pcm"] for r in records)
    ref = reference_checks(t.pool, list(enumerate(t.state.streams)))
    return {"mismatched_samples": (bad, 0),
            "header_mismatches": (headers, 0),
            "size_mismatches": (sizes, 0),
            "stream_mismatches": (ref["mismatched_samples"], 0),
            "undecodable_streams": (ref["undecodable_streams"], 0)}


def control():
    from sela_tpu_torch.codec import decoder
    from sela_tpu_torch.ref.wav import WavData

    sound = decoder.decode_sela

    def lossy(buf, **kw):
        w = sound(buf, **kw)
        return WavData(w.sample_rate, w.bits_per_sample,
                       [c & ~1 for c in w.channels])

    return [(decoder, "decode_sela", lossy)]
