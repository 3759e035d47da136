"""encode: `encode_wav` of the pool's tracks, one after another.

Record: `encoded_pcm` (PCM bytes at the stream's depth), `coded` (the
stream's bytes). Checks: every distinct stream among the kept requests' is
decoded by the reference and compared with its track's PCM. Control: the
program's `encode_wav` of the PCM with its lowest bit cleared, one bit less
than the configuration's depth (a lossy encoder)."""
from __future__ import annotations

from benchmark.traffic import pcm_bytes, reference_checks


def _encode_wav():
    from sela_tpu_torch.codec import encoder   # looked up at call time

    return encoder.encode_wav


def setup(t):
    return None


def request(t, i, metrics):
    track = t.track(i)
    buf = _encode_wav()(t.pool[track], profile=t.profile, metrics=metrics,
                        device=t.device)
    return dict(track=track, encoded_pcm=pcm_bytes(t.cfg), coded=len(buf),
                out=buf if t.kept(i) else None)


def checks(t, records):
    streams = {}
    for r in records:
        seen = streams.setdefault(r["track"], [])
        if r["out"] is not None and not any(r["out"] == s for s in seen):
            seen.append(r["out"])
    todo = [(track, s) for track, ss in streams.items() for s in ss]
    return {k: (v, 0) for k, v in reference_checks(t.pool, todo).items()}


def control():
    from sela_tpu_torch.codec import encoder
    from sela_tpu_torch.ref.wav import WavData

    sound = encoder.encode_wav

    def lossy(w, **kw):
        return sound(WavData(w.sample_rate, w.bits_per_sample,
                             [c & ~1 for c in w.channels]), **kw)

    return [(encoder, "encode_wav", lossy)]
