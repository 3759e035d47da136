"""encode_MBps: PCM bytes (at the stream's depth; MB = 10^6 bytes) of every
request that encoded in the window, over the window's seconds."""


def read(records, window_s):
    pcm = [r["encoded_pcm"] for r in records if "encoded_pcm" in r]
    return sum(pcm) / window_s / 1e6 if pcm else None
