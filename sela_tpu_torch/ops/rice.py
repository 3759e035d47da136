"""Rice planning ops — batched torch (FORMAT.md, normative).

Counterpart of sela_tpu/ops/rice.py: zigzag, per-bit population counts, the
exact cost sums S(k) = sum(u >> k) through S(k) = 2 S(k+1) + counts[k], and
the optimal-k selection: cost(k) = S(k) + n (k+1) over k <= k_max, ties to
the lowest k, the verbatim escape k = 31 (32n bits) when 32n is strictly
cheaper, and (0, 0) for an empty block. The JAX package carries the 64-bit
sums as (int32 hi, uint32 lo) pairs because the TPU has no int64; here they
are native int64. Bit-identical to sela_tpu.ops.rice and to `ksel_pallas`
for every counts <= n <= 65535.

Zigzag values are held as int64 in [0, 2^32): `>>` on torch.uint32 raises
on the CPU, and int64 keeps every shift and comparison plain.

`ksel` is the dispatching wrapper of the K6 kernel (kernels/encode.py,
csrc/ksel.cu); `k_and_bits_reference` is its plain version. `quarter_counts`
is the wrapper of K8 (csrc/quarter_counts.cu), the per-quarter bit counts
of partitioned-residue planning (FORMAT.md §Partitioned residues), and
`quarter_counts_reference` its plain version.
"""
from __future__ import annotations

import torch

from ..format import FRAME_SIZE, RESIDUE_PARTS, RICE_K_ESCAPE, RICE_K_MAX
from ..kernels.encode import ksel_cuda, quarter_counts_cuda

NBITS = 32   # columns of a bit-count row: bit j of the 32-bit zigzag value


def zigzag(v: torch.Tensor) -> torch.Tensor:
    """int32 values -> their uint32 zigzag codes, as int64 in [0, 2^32)."""
    v = v.to(torch.int64)
    return (v << 1) ^ (v >> 63)


def bit_counts(u: torch.Tensor) -> torch.Tensor:
    """[B, N] zigzag codes (zero beyond each row's valid count) -> [B, 32]
    int32; column j = number of codes in the row with bit j set."""
    cols = [((u >> j) & 1).sum(dim=-1) for j in range(NBITS)]
    return torch.stack(cols, dim=-1).to(torch.int32)


def shift_sums_from_counts(counts: torch.Tensor, k_max: int) -> torch.Tensor:
    """[B, 32] bit counts -> [B, k_max + 1] int64; column k = sum(u >> k).

    S(31) = counts[:, 31], S(k) = 2 S(k+1) + counts[:, k]: exact, as
    S(0) < n 2^32 <= 2^48 for n <= 65535."""
    c = counts.to(torch.int64)
    s = c[:, NBITS - 1]
    cols = [s] * NBITS
    for k in range(NBITS - 2, -1, -1):
        s = 2 * s + c[:, k]
        cols[k] = s
    return torch.stack(cols[: k_max + 1], dim=-1)


def k_and_bits_from_sums(sums: torch.Tensor, n_valid: torch.Tensor,
                         k_max: int = RICE_K_MAX):
    """(k [B], bits [B]) int32 from [B, >= k_max + 1] int64 sums(u >> k)."""
    n = n_valid.to(torch.int64)
    best_k = torch.zeros_like(n)
    best_c = torch.full_like(n, 1 << 62)
    for k in range(k_max + 1):
        c = sums[:, k] + n * (k + 1)
        better = c < best_c                 # ascending, strict: lowest k wins
        best_k = torch.where(better, k, best_k)
        best_c = torch.where(better, c, best_c)
    verb = 32 * n
    escape = verb < best_c
    k = torch.where(escape, RICE_K_ESCAPE, best_k)
    bits = torch.where(escape, verb, best_c)
    empty = n == 0
    return (torch.where(empty, 0, k).to(torch.int32),
            torch.where(empty, 0, bits).to(torch.int32))


def k_and_bits_reference(counts: torch.Tensor, n_valid: torch.Tensor,
                         k_max: int = RICE_K_MAX):
    """Plain version of K6: [B, 32] bit counts + [B] value counts ->
    (k [B], bits [B]) int32 (sela_tpu.ops.rice.k_and_bits_from_counts)."""
    return k_and_bits_from_sums(shift_sums_from_counts(counts, k_max),
                                n_valid, k_max)


def ksel(counts: torch.Tensor, n_valid: torch.Tensor, k_max: int = RICE_K_MAX):
    """counts [B, 32] int32 + n_valid [B] int32 -> (k [B], bits [B]) int32.

    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the K6 kernel (csrc/ksel.cu) or raises — there is no fallback.
    """
    if counts.dtype != torch.int32 or n_valid.dtype != torch.int32:
        raise TypeError(f"ksel needs int32 counts and n_valid, got "
                        f"{counts.dtype} and {n_valid.dtype}")
    if (counts.dim() != 2 or counts.shape[1] != NBITS
            or n_valid.shape != (counts.shape[0],)):
        raise ValueError(f"ksel needs counts [B, {NBITS}] and n_valid [B], got "
                         f"{tuple(counts.shape)} and {tuple(n_valid.shape)}")
    if not 0 <= k_max <= RICE_K_MAX:
        raise ValueError(f"ksel: k_max {k_max} outside [0, {RICE_K_MAX}]")
    if not (counts.is_contiguous() and n_valid.is_contiguous()):
        raise ValueError("ksel needs contiguous counts and n_valid")
    if counts.device != n_valid.device:
        raise ValueError(f"counts on {counts.device} but n_valid on "
                         f"{n_valid.device}")
    if counts.device.type == "cpu":
        return k_and_bits_reference(counts, n_valid, k_max)
    if counts.device.type != "cuda":
        raise ValueError(f"ksel: unsupported device {counts.device}")
    return ksel_cuda(counts, n_valid, k_max)


def quarter_bounds(n_valid: torch.Tensor) -> torch.Tensor:
    """[B] value counts -> [B, 5] int32 quarter edges: quarter q of a row is
    [edge q, edge q + 1) = [(q nv) // 4, ((q + 1) nv) // 4)."""
    q = torch.arange(RESIDUE_PARTS + 1, dtype=torch.int32,
                     device=n_valid.device)
    return (q * n_valid.to(torch.int32)[:, None]) // RESIDUE_PARTS


def quarter_counts_reference(e: torch.Tensor,
                             n_valid: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: residues [B, N] int32 + [B] value counts ->
    [B, 4, 32] int32; [b, q, j] = number of samples of row b's quarter q
    whose zigzag code has bit j set (sela_tpu quarter_counts_pallas: each
    quarter masked, then bit_counts). Samples from n_valid on count in no
    quarter, whatever they hold."""
    u = zigzag(e)
    n = torch.arange(e.shape[1], device=e.device)[None, :]
    edges = quarter_bounds(n_valid)[:, :, None]
    inside = [(n >= edges[:, q]) & (n < edges[:, q + 1])
              for q in range(RESIDUE_PARTS)]
    return torch.stack([bit_counts(torch.where(m, u, 0)) for m in inside],
                       dim=1)


def quarter_counts(e: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """e [B, N] int32 (N <= 2048) + n_valid [B] int32 -> [B, 4, 32] int32
    per-quarter bit counts.

    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the K8 kernel (csrc/quarter_counts.cu) or raises — there is no
    fallback.
    """
    if e.dtype != torch.int32 or n_valid.dtype != torch.int32:
        raise TypeError(f"quarter_counts needs int32 e and n_valid, got "
                        f"{e.dtype} and {n_valid.dtype}")
    if (e.dim() != 2 or e.shape[1] > FRAME_SIZE
            or n_valid.shape != (e.shape[0],)):
        raise ValueError(f"quarter_counts needs e [B, N <= {FRAME_SIZE}] and "
                         f"n_valid [B], got {tuple(e.shape)} and "
                         f"{tuple(n_valid.shape)}")
    if not (e.is_contiguous() and n_valid.is_contiguous()):
        raise ValueError("quarter_counts needs contiguous e and n_valid")
    if e.device != n_valid.device:
        raise ValueError(f"e on {e.device} but n_valid on {n_valid.device}")
    if e.device.type == "cpu":
        return quarter_counts_reference(e, n_valid)
    if e.device.type != "cuda":
        raise ValueError(f"quarter_counts: unsupported device {e.device}")
    return quarter_counts_cuda(e, n_valid)


def block_words(bits: torch.Tensor) -> torch.Tensor:
    """ceil(bits / 32): the u32 words of a block."""
    return (bits + 31) >> 5


def plan_blocks(values: torch.Tensor, n_valid: torch.Tensor,
                k_max: int = RICE_K_MAX):
    """int32 value blocks [B, N] + [B] counts -> (k, bits, nwords), [B] int32."""
    valid = (torch.arange(values.shape[1], device=values.device)[None, :]
             < n_valid[:, None])
    u = torch.where(valid, zigzag(values), 0)
    k, bits = ksel(bit_counts(u), n_valid.to(torch.int32).contiguous(), k_max)
    return k, bits, block_words(bits)
