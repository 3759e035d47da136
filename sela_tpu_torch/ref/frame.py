"""Per-frame codec: channel decorrelation + subframe assembly — numpy oracle.

Capability parity target: upstream:src/frame/frame_encoder.cpp,
frame_decoder.cpp (sahaRatul/sela, path-level cite — mount empty, SURVEY.md SS2).

Stereo pairs (2i, 2i+1) may be coded direct (L, R) or mid/side per frame;
the encoder picks whichever yields fewer exact Rice bits. Mid/side math is
normative per FORMAT.md:
    mid = (L + R) >> 1,  side = L - R
    L = mid + ((side + (side & 1)) >> 1),  R = L - side
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..errors import ContainerError
from ..format import Q_CLAMP_HI, Q_CLAMP_LO, SF_DIRECT, SF_MID, SF_SIDE
from . import lpc, rice


def check_coeff_range(q: np.ndarray) -> None:
    """Normative (FORMAT.md §Decoder validation): decoded quantized
    reflection coefficients MUST lie in [-64, 63] — the encoder clamp range.

    Out-of-range values can only appear in crafted containers; before this
    rule they reached the dequantize/Levinson stage, where the int64 oracle,
    the jnp path, and the kernels (which clamp |g| <= 2^20 for their
    limb-arithmetic bounds) produced DIFFERENT deterministic garbage
    (ADVICE r4). Rejecting at unpack restores cross-path bit-identity on
    every accepted stream.
    """
    q = np.asarray(q)
    if q.size and (q.min() < Q_CLAMP_LO or q.max() > Q_CLAMP_HI):
        raise ContainerError("quantized coefficient out of range")


@dataclass
class SubFrame:
    channel: int
    sftype: int          # SF_DIRECT / SF_MID / SF_SIDE
    order: int
    k_coeff: int
    coeff_words: np.ndarray  # uint32
    k_res: int               # 0..31, or RICE_PARTITION_MARKER (32)
    res_words: np.ndarray    # uint32
    n_samples: int
    # sub-block ks when k_res == RICE_PARTITION_MARKER (FORMAT.md
    # §Partitioned residues), else None
    k_res_sub: list[int] | None = None


def mid_side(left: np.ndarray, right: np.ndarray):
    l64 = left.astype(np.int64)
    r64 = right.astype(np.int64)
    mid = ((l64 + r64) >> 1).astype(np.int32)
    side = (l64 - r64).astype(np.int32)
    return mid, side


def inverse_mid_side(mid: np.ndarray, side: np.ndarray):
    m64 = mid.astype(np.int64)
    s64 = side.astype(np.int64)
    left = m64 + ((s64 + (s64 & 1)) >> 1)
    right = left - s64
    return left.astype(np.int32), right.astype(np.int32)


def _encode_signal(x: np.ndarray, max_order: int = 32, rice_k_max: int = 30,
                   partition: int = 1):
    """Full per-signal path: analyze -> render -> rice. Returns (subframe
    fields minus channel/type, exact total payload bits).

    partition > 1 enables the adaptive partitioned-residue mode (FORMAT.md
    §Partitioned residues): the encoder costs both the plain block and the
    partitioned block (sub-block ks + 4 header bytes) exactly, and emits
    whichever is smaller — so enabling it never increases any subframe."""
    from ..format import RICE_PARTITION_MARKER

    order, q = lpc.analyze_channel(x, max_order)
    order, q, e = lpc.render_channel(x, order, q)
    k_c, cw = rice.encode(q, k_max=rice_k_max)
    u = rice.zigzag(e)
    k_r = rice.optimal_k(u, rice_k_max)
    plain_bits = int(rice.bit_lengths(u, k_r).sum())
    ks = None
    if partition > 1 and len(e) >= partition:
        ks_p, part_bits = rice.partitioned_cost_bits(e, partition, rice_k_max)
        # partitioned payload pays `partition` extra k bytes in the header
        if 32 * -(-part_bits // 32) + 8 * partition < 32 * -(-plain_bits // 32):
            ks = ks_p
    if ks is not None:
        k_r = RICE_PARTITION_MARKER
        _, rw = rice.encode_partitioned(e, partition, rice_k_max)
        bits = 32 * (len(cw) + len(rw)) + 8 * partition
    else:
        k_r, rw = rice.encode(e, k=k_r, k_max=rice_k_max)
        bits = 32 * (len(cw) + len(rw))
    return order, q, k_c, cw, k_r, rw, ks, bits


def encode_frame(channels: list[np.ndarray], max_order: int = 32,
                 rice_k_max: int = 30, allow_ms: bool = True,
                 partition: int = 1) -> list[SubFrame]:
    nch = len(channels)
    n = len(channels[0]) if nch else 0
    subframes: list[SubFrame] = []
    enc = lambda x: _encode_signal(x, max_order, rice_k_max, partition)
    ch = 0
    while ch < nch:
        if ch + 1 < nch:
            left, right = channels[ch], channels[ch + 1]
            enc_l = enc(left)
            enc_r = enc(right)
            if allow_ms:
                mid, side = mid_side(left, right)
                enc_m = enc(mid)
                enc_s = enc(side)
                use_ms = enc_m[-1] + enc_s[-1] < enc_l[-1] + enc_r[-1]
            else:
                use_ms = False
            if use_ms:
                picks = [(SF_MID, enc_m), (SF_SIDE, enc_s)]
            else:
                picks = [(SF_DIRECT, enc_l), (SF_DIRECT, enc_r)]
            for off, (t, e) in enumerate(picks):
                order, q, k_c, cw, k_r, rw, ks, _ = e
                subframes.append(
                    SubFrame(ch + off, t, order, k_c, cw, k_r, rw, n, ks)
                )
            ch += 2
        else:
            order, q, k_c, cw, k_r, rw, ks, _ = enc(channels[ch])
            subframes.append(
                SubFrame(ch, SF_DIRECT, order, k_c, cw, k_r, rw, n, ks)
            )
            ch += 1
    return subframes


def validate_subframe_layout(channels: list[int], types: list[int],
                             nch: int) -> None:
    """Normative frame-layout rules (FORMAT.md): every decode path enforces
    these BEFORE touching sample data, so malformed containers raise
    ContainerError instead of crashing or silently mis-decoding.

      - exactly nch subframes; channel bytes are a permutation of 0..nch-1
      - sftype in {DIRECT, MID, SIDE}
      - MID appears only at an even channel c with c+1 < nch, and the
        subframe for channel c+1 is then SIDE; SIDE appears only as that
        partner (matches the encoder, which pairs channels (2p, 2p+1)).
    """
    if len(channels) != nch:
        raise ContainerError("wrong subframe count")
    t = [-1] * nch
    for ch, ty in zip(channels, types):
        if not 0 <= ch < nch:
            raise ContainerError(f"subframe channel {ch} out of range")
        if t[ch] != -1:
            raise ContainerError(f"duplicate subframe channel {ch}")
        if not SF_DIRECT <= ty <= SF_SIDE:
            raise ContainerError(f"bad subframe type {ty}")
        t[ch] = ty
    for c in range(nch):
        if t[c] == SF_MID and (c % 2 or c + 1 >= nch or t[c + 1] != SF_SIDE):
            raise ContainerError(f"MID subframe at channel {c} has no SIDE partner")
        if t[c] == SF_SIDE and (c % 2 == 0 or t[c - 1] != SF_MID):
            raise ContainerError(f"orphan SIDE subframe at channel {c}")


def decode_frame(subframes: list[SubFrame], nch: int) -> list[np.ndarray]:
    validate_subframe_layout(
        [sf.channel for sf in subframes], [sf.sftype for sf in subframes], nch
    )
    from ..format import RICE_PARTITION_MARKER

    raw: list[np.ndarray] = [None] * nch  # type: ignore[list-item]
    types = [SF_DIRECT] * nch
    for sf in subframes:
        q = rice.decode(sf.coeff_words, sf.order, sf.k_coeff)
        check_coeff_range(q)
        if sf.k_res == RICE_PARTITION_MARKER:
            e = rice.decode_partitioned(sf.res_words, sf.n_samples,
                                        sf.k_res_sub)
        else:
            e = rice.decode(sf.res_words, sf.n_samples, sf.k_res)
        raw[sf.channel] = lpc.reconstruct_channel(e, sf.order, q)
        types[sf.channel] = sf.sftype
    out: list[np.ndarray] = [None] * nch  # type: ignore[list-item]
    ch = 0
    while ch < nch:
        if ch + 1 < nch and types[ch] == SF_MID:
            out[ch], out[ch + 1] = inverse_mid_side(raw[ch], raw[ch + 1])
            ch += 2
        else:
            out[ch] = raw[ch]
            ch += 1
    return out
