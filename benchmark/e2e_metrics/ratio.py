"""ratio: coded bytes over PCM bytes, summed over every request that encoded
in the window: what an archive stores per byte of audio."""


def read(records, window_s):
    enc = [r for r in records if "encoded_pcm" in r]
    pcm = sum(r["encoded_pcm"] for r in enc)
    return sum(r["coded"] for r in enc) / pcm if pcm else None
