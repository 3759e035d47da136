"""Rice packing of plain blocks on the device (FORMAT.md §Rice, normative).

Counterpart of sela_tpu/ops/pack.py. Each row of a [B, N] batch is one Rice
block of its first n_valid values with one parameter k <= RICE_K_MAX; its
word stream is byte-identical to the host packer's (native/bitio.cpp,
ref.rice.encode). Escape (k = 31) and partitioned blocks are not plain
blocks and stay on the host packer.

The complement-space formulation of the JAX version: in the complement of
the stream a value's unary run is all zeros, so value i contributes one
(k + 1)-bit pattern, its stop bit 1 then ~u's k low bits, ending at bit
off_i + q_i + k, over at most two words; patterns of different values have
disjoint bits, so their sum per word is their OR, and the row is the
complement under the mask of its bit count. Offsets are int64 here: the JAX
version's uint32 cumsum wraps for a row past 2^32 bits (forced small k on
wide values), so the two agree only below that.

`pack_blocks` is the dispatching wrapper of the kernel (csrc/pack.cu,
launcher kernels/pack.py); `pack_blocks_reference` is its plain version.
`pack_blocks_at` (plain version `pack_blocks_at_reference`) writes each row
at a given word offset of one flat buffer: the encoder's entry, which packs
a v1 chunk's blocks on the card (codec/encoder.py).
"""
from __future__ import annotations

import torch

from ..format import FRAME_SIZE, RICE_K_MAX
from ..kernels.pack import pack_blocks_at_cuda, pack_blocks_cuda
from .rice import zigzag

_U32 = 0xFFFFFFFF


def pack_blocks_reference(u: torch.Tensor, k: torch.Tensor,
                          n_valid: torch.Tensor, max_words: int):
    """Plain version: u [B, N] zigzag codes as int64 in [0, 2^32), zero from
    n_valid on; k and n_valid [B] -> (words [B, max_words] int32 holding the
    uint32 bits, nwords [B] int64). Words past nwords are zero; a row whose
    words exceed max_words keeps its first max_words and reports its true
    nwords."""
    B, N = u.shape
    dev = u.device
    k = k.to(torch.int64)[:, None]
    valid = (torch.arange(N, device=dev)[None, :]
             < n_valid.to(torch.int64)[:, None])
    q = u >> k
    lens = torch.where(valid, q + 1 + k, 0)
    offs = torch.cumsum(lens, dim=1) - lens           # exclusive, exact
    total = lens.sum(dim=1)
    stop = offs + q                                   # each stop bit
    pat = (1 << k) | (~u & ((1 << k) - 1))            # k + 1 bits
    w0 = stop >> 5
    end = (stop & 31) + k                             # <= 61
    # both branches are evaluated: clamp the shifts of the discarded one
    hi = torch.where(end <= 31, pat << (31 - end).clamp(min=0),
                     pat >> (end - 31).clamp(min=0))
    lo = torch.where(end <= 31, 0, (pat << (63 - end).clamp(max=31)) & _U32)
    # per-word sums over a spare column that takes what falls outside
    words_c = torch.zeros((B, max_words + 1), dtype=torch.int64, device=dev)
    for part, w in ((hi, w0), (lo, w0 + 1)):
        idx = torch.where(valid & (w < max_words), w, max_words)
        words_c.scatter_add_(1, idx, torch.where(valid, part, 0))
    left = total[:, None] - 32 * torch.arange(max_words, device=dev)[None, :]
    mask = (_U32 << (32 - left.clamp(0, 32))) & _U32
    words = ~words_c[:, :max_words] & mask
    words = torch.where(words > 0x7FFFFFFF, words - (1 << 32), words)
    return words.to(torch.int32), (total + 31) >> 5


def pack_blocks(values: torch.Tensor, k: torch.Tensor, n_valid: torch.Tensor,
                max_words: int):
    """values [B, N] int32 (N <= 2048), k and n_valid [B] int32, 0 <= k <=
    RICE_K_MAX -> (words [B, max_words] int32 holding the uint32 bits,
    nwords [B] int64): row b's first nwords[b] words are
    ref.rice.encode(values[b, :n_valid[b]], k[b])[1], and its words past them
    zero.

    The values are zigzagged and masked from n_valid on. On CPU tensors this
    runs the plain version; on CUDA tensors it launches the kernel
    (csrc/pack.cu) or raises — there is no fallback. k = 31 (the escape) and
    32 (the partition marker) are refused (the JAX version silently gives
    wrong words for them); checking k reads it, one device-to-host copy."""
    if any(t.dtype != torch.int32 for t in (values, k, n_valid)):
        raise TypeError(f"pack_blocks needs int32 values, k and n_valid, got "
                        f"{values.dtype}, {k.dtype} and {n_valid.dtype}")
    if (values.dim() != 2 or values.shape[1] > FRAME_SIZE
            or k.shape != (values.shape[0],) or n_valid.shape != k.shape):
        raise ValueError(f"pack_blocks needs values [B, N <= {FRAME_SIZE}], k "
                         f"and n_valid [B], got {tuple(values.shape)}, "
                         f"{tuple(k.shape)} and {tuple(n_valid.shape)}")
    if not all(t.is_contiguous() for t in (values, k, n_valid)):
        raise ValueError("pack_blocks needs contiguous values, k and n_valid")
    if not (values.device == k.device == n_valid.device):
        raise ValueError(f"values on {values.device}, k on {k.device}, n_valid "
                         f"on {n_valid.device}")
    if not isinstance(max_words, int) or max_words < 1:
        raise ValueError(f"pack_blocks: max_words must be an int >= 1, got "
                         f"{max_words!r}")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pack_blocks: unsupported device {values.device}")
    if k.numel() and bool(((k < 0) | (k > RICE_K_MAX)).any()):
        raise ValueError(f"pack_blocks packs plain blocks, 0 <= k <= "
                         f"{RICE_K_MAX}; escape and partitioned blocks stay "
                         f"on the host packer")
    if values.device.type == "cuda":
        return pack_blocks_cuda(values, k, n_valid, max_words)
    valid = (torch.arange(values.shape[1])[None, :]
             < n_valid.to(torch.int64)[:, None])
    u = torch.where(valid, zigzag(values), 0)
    return pack_blocks_reference(u, k, n_valid, max_words)


def pack_blocks_at_reference(values: torch.Tensor, k: torch.Tensor,
                             n_valid: torch.Tensor, offs: torch.Tensor,
                             caps: torch.Tensor,
                             words: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's sela_pack_at entry, on CPU tensors:
    writes words (in place) and returns nwords, as pack_blocks_at says."""
    B, N = values.shape
    T = words.numel()
    plain = (k >= 0) & (k <= RICE_K_MAX)
    ks = torch.where(plain, k, 0)
    nv = torch.where(plain, n_valid.clamp(0, N), 0)
    valid = torch.arange(N)[None, :] < nv.to(torch.int64)[:, None]
    u = torch.where(valid, zigzag(values), 0)
    # a row's span: its cap, clipped to the buffer; none for other rows
    room = torch.where((offs >= 0) & (offs < T), T - offs, 0)
    cap = torch.where(plain, torch.minimum(caps.clamp(min=0).to(torch.int64),
                                           room), 0)
    span = int(cap.max()) if B else 0
    dense, nwords = pack_blocks_reference(u, ks, nv, max(span, 1))
    cols = torch.arange(span)
    sel = cols[None, :] < cap[:, None]
    words[(offs[:, None] + cols[None, :])[sel]] = dense[:, :span][sel]
    return torch.where(plain, nwords, -1)


def pack_blocks_at(values: torch.Tensor, k: torch.Tensor,
                   n_valid: torch.Tensor, offs: torch.Tensor,
                   caps: torch.Tensor, total_words: int, out=None):
    """values [B, N] int32 (N <= 2048), k, n_valid and caps [B] int32, offs
    [B] int64 -> (words [total_words] int32 holding the uint32 bits, nwords
    [B] int64).

    A row with 0 <= k <= RICE_K_MAX writes its block,
    ref.rice.encode(values[b, :n_valid[b]], k[b])[1] cut or zero-padded to
    caps[b] words, at words[offs[b] : offs[b] + caps[b]] (clipped to the
    buffer), and its true word count to nwords[b]. Other rows (k = 31, the
    escape; 32, the partition marker) get nwords -1 and write nothing:
    their spans keep what `out` held. out: the [total_words] int32 buffer
    to write into (default: a new one, zeros on the CPU, uninitialized on
    the card).

    The encoder's use (codec/encoder.py::device_pack): caps the planned
    word counts and offs their exclusive cumsum, so the words land in emit
    order and a wrong plan shows in nwords without touching the next row.
    Checks dtypes, shapes, contiguity and devices, and reads no value, so
    it adds no sync. On CPU tensors this runs the plain version; on CUDA
    tensors it launches the kernel (csrc/pack.cu, sela_pack_at) or raises —
    there is no fallback."""
    ints = (values, k, n_valid, caps)
    if any(t.dtype != torch.int32 for t in ints) or offs.dtype != torch.int64:
        raise TypeError(f"pack_blocks_at needs int32 values, k, n_valid and "
                        f"caps and int64 offs, got {values.dtype}, {k.dtype}, "
                        f"{n_valid.dtype}, {caps.dtype} and {offs.dtype}")
    B = values.shape[0] if values.dim() == 2 else -1
    if (values.dim() != 2 or values.shape[1] > FRAME_SIZE
            or any(t.shape != (B,) for t in (k, n_valid, offs, caps))):
        raise ValueError(f"pack_blocks_at needs values [B, N <= {FRAME_SIZE}] "
                         f"and k, n_valid, offs and caps [B], got "
                         f"{tuple(values.shape)}, {tuple(k.shape)}, "
                         f"{tuple(n_valid.shape)}, {tuple(offs.shape)} and "
                         f"{tuple(caps.shape)}")
    if not isinstance(total_words, int) or total_words < 0:
        raise ValueError(f"pack_blocks_at: total_words must be an int >= 0, "
                         f"got {total_words!r}")
    dev = values.device
    if out is None:
        make = torch.zeros if dev.type == "cpu" else torch.empty
        out = make(total_words, dtype=torch.int32, device=dev)
    elif out.dtype != torch.int32 or out.shape != (total_words,):
        raise ValueError(f"pack_blocks_at: out must be int32 [{total_words}], "
                         f"got {out.dtype} {tuple(out.shape)}")
    tensors = ints + (offs, out)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pack_blocks_at needs contiguous tensors")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"pack_blocks_at needs every tensor on {dev}, got "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type == "cuda":
        return out, pack_blocks_at_cuda(values, k, n_valid, offs, caps, out)
    if dev.type != "cpu":
        raise ValueError(f"pack_blocks_at: unsupported device {dev}")
    return out, pack_blocks_at_reference(values, k, n_valid, offs, caps, out)
