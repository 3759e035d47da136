"""`.sela` container serialization — numpy oracle (normative, FORMAT.md).

Capability parity target: upstream:src/file/sela_file.cpp (sahaRatul/sela,
path-level cite — mount empty, SURVEY.md SS2).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..errors import ContainerError  # noqa: F401  (re-export: stable API)
from ..format import (
    MAGIC,
    MAX_FRAME_SAMPLES,
    RESIDUE_PARTS,
    RICE_PARTITION_MARKER,
    SYNC,
    TAG_MAGIC,
    TAG_MAX_BYTES,
)
from .frame import SubFrame


@dataclass
class SelaHeader:
    sample_rate: int
    bits_per_sample: int
    channels: int
    num_frames: int


def serialize_subframe(sf: SubFrame) -> bytes:
    parts = [
        struct.pack(
            "<BBBBH", sf.channel, sf.sftype, sf.order, sf.k_coeff, len(sf.coeff_words)
        ),
        np.asarray(sf.coeff_words, dtype="<u4").tobytes(),
    ]
    if sf.k_res == RICE_PARTITION_MARKER:
        # FORMAT.md §Partitioned residues: marker byte, then one k per
        # sub-block, then the usual word count
        assert sf.k_res_sub is not None and len(sf.k_res_sub) == RESIDUE_PARTS
        parts.append(struct.pack(
            f"<B{RESIDUE_PARTS}BI", RICE_PARTITION_MARKER,
            *[int(k) for k in sf.k_res_sub], len(sf.res_words),
        ))
    else:
        parts.append(struct.pack("<BI", sf.k_res, len(sf.res_words)))
    parts.append(np.asarray(sf.res_words, dtype="<u4").tobytes())
    return b"".join(parts)


def serialize_frame(subframes: list[SubFrame], n_samples: int) -> bytes:
    out = [struct.pack("<IH", SYNC, n_samples)]
    out += [serialize_subframe(sf) for sf in subframes]
    return b"".join(out)


def serialize_file(header: SelaHeader, frames: list[bytes]) -> bytes:
    head = MAGIC + struct.pack(
        "<IHBI", header.sample_rate, header.bits_per_sample, header.channels,
        header.num_frames,
    )
    return head + b"".join(frames)


HEADER_SIZE = 4 + 4 + 2 + 1 + 4


def parse_header(buf: bytes) -> SelaHeader:
    if len(buf) < HEADER_SIZE or buf[:4] != MAGIC:
        raise ContainerError("bad magic — not a sela file")
    rate, bps, nch, nframes = struct.unpack_from("<IHBI", buf, 4)
    if nch == 0:
        raise ContainerError("zero channels")
    # plausibility bound BEFORE any F*C-sized allocation: every frame costs
    # at least 6 header bytes + 11 bytes per subframe, so a corrupt header
    # claiming ~2^32 frames is rejected here instead of driving the scanners
    # into a 100+ GiB allocation (found by header-region fuzz)
    if nframes * (6 + 11 * nch) > len(buf) - HEADER_SIZE:
        raise ContainerError(
            f"frame count {nframes} impossible for a {len(buf)}-byte file"
        )
    return SelaHeader(rate, bps, nch, nframes)


def parse_subframe(buf: bytes, pos: int, n_samples: int) -> tuple[SubFrame, int]:
    from ..format import MAX_ORDER, RICE_K_ESCAPE

    if pos + 6 > len(buf):
        raise ContainerError("truncated subframe header")
    ch, sftype, order, k_c, nwc = struct.unpack_from("<BBBBH", buf, pos)
    if order > MAX_ORDER:
        raise ContainerError(f"LPC order {order} out of range")
    if k_c > RICE_K_ESCAPE:
        raise ContainerError(f"coefficient rice k {k_c} out of range")
    pos += 6
    if pos + 4 * nwc > len(buf):
        raise ContainerError("truncated coefficient block")
    cw = np.frombuffer(buf, dtype="<u4", count=nwc, offset=pos).astype(np.uint32)
    pos += 4 * nwc
    if pos + 5 > len(buf):
        raise ContainerError("truncated residue block header")
    k_r = buf[pos]
    k_sub = None
    if k_r == RICE_PARTITION_MARKER:
        # FORMAT.md §Partitioned residues: 4 sub-block ks follow the marker
        if pos + 1 + RESIDUE_PARTS + 4 > len(buf):
            raise ContainerError("truncated partitioned residue header")
        k_sub = list(buf[pos + 1 : pos + 1 + RESIDUE_PARTS])
        if any(k > RICE_K_ESCAPE for k in k_sub):
            raise ContainerError(f"partitioned residue rice k {k_sub} out of range")
        (nwr,) = struct.unpack_from("<I", buf, pos + 1 + RESIDUE_PARTS)
        pos += 1 + RESIDUE_PARTS + 4
    elif k_r > RICE_K_ESCAPE:
        raise ContainerError(f"residue rice k {k_r} out of range")
    else:
        (nwr,) = struct.unpack_from("<I", buf, pos + 1)
        pos += 5
    if pos + 4 * nwr > len(buf):
        raise ContainerError("truncated residue block")
    rw = np.frombuffer(buf, dtype="<u4", count=nwr, offset=pos).astype(np.uint32)
    pos += 4 * nwr
    return SubFrame(ch, sftype, order, k_c, cw, k_r, rw, n_samples, k_sub), pos


def serialize_tags(tags: dict) -> bytes:
    """Optional metadata trailer (APEv2-capability parity — FORMAT.md §Tags).

    Keys are str (UTF-8); values str or bytes. Placed after the last frame:
    TAG_MAGIC, u32 payload bytes, then per item u16 keyLen, u32 valLen,
    key, value.
    """
    items = []
    for k, v in tags.items():
        kb = k.encode("utf-8")
        vb = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        if len(kb) > 0xFFFF:
            raise ContainerError(f"tag key too long: {len(kb)}")
        items.append(struct.pack("<HI", len(kb), len(vb)) + kb + vb)
    payload = b"".join(items)
    if len(payload) > TAG_MAX_BYTES:
        raise ContainerError(f"tags block too large: {len(payload)}")
    return TAG_MAGIC + struct.pack("<I", len(payload)) + payload


def parse_tags(buf: bytes, pos: int) -> tuple[dict, int]:
    """Parse a tags trailer at pos; returns (tags, new_pos)."""
    if pos + 8 > len(buf) or buf[pos : pos + 4] != TAG_MAGIC:
        raise ContainerError("bad tags trailer magic")
    (nbytes,) = struct.unpack_from("<I", buf, pos + 4)
    pos += 8
    if nbytes > TAG_MAX_BYTES or pos + nbytes > len(buf):
        raise ContainerError("truncated tags trailer")
    end = pos + nbytes
    tags: dict = {}
    while pos < end:
        if pos + 6 > end:
            raise ContainerError("truncated tag item header")
        klen, vlen = struct.unpack_from("<HI", buf, pos)
        pos += 6
        if pos + klen + vlen > end:
            raise ContainerError("truncated tag item")
        try:
            key = buf[pos : pos + klen].decode("utf-8", errors="strict")
        except UnicodeDecodeError:
            raise ContainerError("malformed tag key (not UTF-8)") from None
        pos += klen
        val = bytes(buf[pos : pos + vlen])
        pos += vlen
        try:
            tags[key] = val.decode("utf-8")
        except UnicodeDecodeError:
            tags[key] = val
    return tags, end


# --- APEv2 wire format (reference parity: the C lineage's core/apev2.c
# read/wrote real APEv2 blocks; upstream:core/apev2.c, path-level cite —
# mount empty, SURVEY.md §2 "APEv2 tags" row). Layout per the public APEv2
# spec: optional 32-byte header, items, mandatory 32-byte footer; header &
# footer are "APETAGEX", version u32 LE = 2000, tagSize u32 LE (items +
# footer, header NOT counted), itemCount u32 LE, flags u32 LE, 8 reserved
# zero bytes. Item: valueSize u32 LE, itemFlags u32 LE (bits 1-2: 0 = UTF-8
# text, 1 = binary), ASCII key (0x20..0x7E), 0x00, value bytes. -----------

APE_PREAMBLE = b"APETAGEX"
APE_VERSION = 2000
APE_FLAG_HAS_HEADER = 1 << 31
APE_FLAG_IS_HEADER = 1 << 29


def serialize_tags_apev2(tags: dict) -> bytes:
    """Serialize metadata as a real APEv2 block (header + items + footer)."""
    items = b""
    for k, v in tags.items():
        try:
            kb = k.encode("ascii", errors="strict") if isinstance(k, str) else k
        except UnicodeEncodeError:
            raise ContainerError(
                f"APEv2 key must be printable ASCII: {k!r}") from None
        if not kb or any(c < 0x20 or c > 0x7E for c in kb):
            raise ContainerError(f"APEv2 key must be printable ASCII: {k!r}")
        if isinstance(v, str):
            vb, iflags = v.encode("utf-8"), 0
        else:
            vb, iflags = bytes(v), 1 << 1
        items += struct.pack("<II", len(vb), iflags) + kb + b"\x00" + vb
    if len(items) > TAG_MAX_BYTES:
        raise ContainerError(f"tags block too large: {len(items)}")
    size = len(items) + 32  # items + footer; header not counted (spec)

    def block(is_header: bool) -> bytes:
        flags = APE_FLAG_HAS_HEADER | (APE_FLAG_IS_HEADER if is_header else 0)
        return (APE_PREAMBLE
                + struct.pack("<IIII", APE_VERSION, size, len(tags), flags)
                + b"\x00" * 8)

    return block(True) + items + block(False)


def _parse_ape_block(buf: bytes, off: int):
    if off + 32 > len(buf) or buf[off : off + 8] != APE_PREAMBLE:
        raise ContainerError("bad APEv2 preamble")
    version, size, count, flags = struct.unpack_from("<IIII", buf, off + 8)
    if version != APE_VERSION:
        raise ContainerError(f"unsupported APEv2 version {version}")
    if buf[off + 24 : off + 32] != b"\x00" * 8:
        raise ContainerError("nonzero APEv2 reserved bytes")
    return size, count, flags


def parse_tags_apev2(buf: bytes, pos: int) -> tuple[dict, int]:
    """Parse an APEv2 block spanning exactly [pos, len(buf)).

    Accepts both header+footer blocks (what serialize_tags_apev2 emits) and
    the footer-only form other writers produce.
    """
    size, count, flags = _parse_ape_block(buf, len(buf) - 32)
    if flags & APE_FLAG_IS_HEADER:
        raise ContainerError("APEv2 footer flagged as header")
    if size < 32 or size - 32 > TAG_MAX_BYTES:
        raise ContainerError("APEv2 size out of range")
    has_header = bool(flags & APE_FLAG_HAS_HEADER)
    total = size + (32 if has_header else 0)
    if len(buf) - pos != total:
        raise ContainerError("APEv2 block does not span the trailer")
    if has_header:
        hsize, hcount, hflags = _parse_ape_block(buf, pos)
        if not hflags & APE_FLAG_IS_HEADER or hsize != size or hcount != count:
            raise ContainerError("APEv2 header/footer mismatch")
    p = len(buf) - size
    end_items = len(buf) - 32
    tags: dict = {}
    for _ in range(count):
        if p + 8 > end_items:
            raise ContainerError("truncated APEv2 item")
        vlen, iflags = struct.unpack_from("<II", buf, p)
        p += 8
        z = buf.find(b"\x00", p, end_items)
        if z < 0 or z == p:
            raise ContainerError("malformed APEv2 key")
        kb = buf[p:z]
        if any(c < 0x20 or c > 0x7E for c in kb):
            raise ContainerError("non-ASCII APEv2 key")
        p = z + 1
        if p + vlen > end_items:
            raise ContainerError("truncated APEv2 value")
        vb = bytes(buf[p : p + vlen])
        p += vlen
        if (iflags >> 1) & 0x3 == 0:
            try:
                tags[kb.decode("ascii")] = vb.decode("utf-8")
            except UnicodeDecodeError:
                tags[kb.decode("ascii")] = vb
        else:
            tags[kb.decode("ascii")] = vb
    if p != end_items:
        raise ContainerError("APEv2 items do not fill the tag block")
    return tags, len(buf)


def parse_trailer(buf: bytes, pos: int) -> dict:
    """After the last frame: nothing, or one tags block (SeTg or APEv2).

    Junk raises. Format is auto-detected: SeTg blocks lead with TAG_MAGIC at
    pos; APEv2 blocks end with an APETAGEX footer at the end of the buffer.
    """
    if pos == len(buf):
        return {}
    if buf[pos : pos + 4] == TAG_MAGIC:
        tags, end = parse_tags(buf, pos)
        if end != len(buf):
            raise ContainerError("trailing bytes after tags trailer")
        return tags
    if len(buf) >= pos + 32 and buf[len(buf) - 32 : len(buf) - 24] == APE_PREAMBLE:
        tags, _ = parse_tags_apev2(buf, pos)
        return tags
    raise ContainerError("bad tags trailer magic")


def frames_end(buf: bytes) -> int:
    """Offset just past the last frame (start of the optional tags trailer)."""
    h = parse_header(buf)
    pos = HEADER_SIZE
    for _ in range(h.num_frames):
        _, _, pos = parse_frame(buf, pos, h.channels)
    return pos


def read_tags(buf: bytes) -> dict:
    """Metadata from a .sela buffer ({} when absent)."""
    return parse_trailer(buf, frames_end(buf))


def replace_tags(buf: bytes, tags: dict | None, fmt: str = "setg") -> bytes:
    """New buffer with the tags trailer replaced (removed if tags is falsy).

    The audio payload is untouched — tag editing never re-encodes
    (capability parity with the C lineage's core/apev2.c, SURVEY.md §2).
    fmt selects the wire format for the NEW trailer: "setg" (this profile's
    compact block) or "apev2" (real APEv2 header+items+footer, readable by
    standard APEv2 tooling). Reads auto-detect either format."""
    if fmt not in ("setg", "apev2"):
        raise ContainerError(f"unknown tag format {fmt!r}")
    end = frames_end(buf)
    parse_trailer(buf, end)  # validate the existing trailer, if any
    base = bytes(buf[:end])
    if not tags:
        return base
    ser = serialize_tags if fmt == "setg" else serialize_tags_apev2
    return base + ser(tags)


def parse_frame(buf: bytes, pos: int, nch: int) -> tuple[list[SubFrame], int, int]:
    """Returns (subframes, n_samples, new_pos)."""
    if pos + 6 > len(buf):
        raise ContainerError("truncated frame header")
    sync, n_samples = struct.unpack_from("<IH", buf, pos)
    if sync != SYNC:
        raise ContainerError(f"bad frame sync at offset {pos}: {sync:#010x}")
    if not 0 < n_samples <= MAX_FRAME_SAMPLES:
        raise ContainerError(f"bad frame sample count: {n_samples}")
    pos += 6
    subframes = []
    for _ in range(nch):
        sf, pos = parse_subframe(buf, pos, n_samples)
        subframes.append(sf)
    return subframes, n_samples, pos
