"""Device steps of the codec: one chunk of frames at a time.

Counterpart of sela_tpu/codec/pipeline.py, with the same layouts at the
boundary of each step:
- `encode_step`: PCM [F, C, S] + n_valid [F] -> the planning arrays and
  residues of the chunk, the mid/side decision applied (the JAX
  encode_step's fused branch: K3 + K4 analysis on every candidate row, then
  the render, K1 -> K5 -> one K6 call, on the rows it needs);
- `decode_step`: residues [F, C, S], qcoeffs [F, C, 32], order and sftype
  [F, C] -> PCM (K1, then K2/K7).
Kernel routing depends on the device only: on CUDA tensors the kernels
serve every bit depth; on CPU tensors their plain versions run.

Shapes: F frames per chunk, C channels, S samples a frame, B = F C2
candidate rows with C2 = C + 2 (C // 2) (L, R, then mid and side of each
pair).
"""
from __future__ import annotations

import torch

from ..format import MAX_ORDER, RICE_K_MAX, SF_DIRECT, SF_MID, SF_SIDE
from ..kernels.iir import iir_synthesize
from ..ops.analysis import analyze
from ..ops.coeffs import lpc_from_q
from ..ops.filters import fir_rice
from ..ops.rice import bit_counts, block_words, ksel, zigzag


def _mid_side(left: torch.Tensor, right: torch.Tensor):
    # mid = (L + R) >> 1 exactly, without int32 overflow, via the identity
    # (a + b) >> 1 == (a >> 1) + (b >> 1) + (a & b & 1) for arithmetic shifts
    mid = (left >> 1) + (right >> 1) + (left & right & 1)
    side = left - right   # |L - R| < 2^25 for PCM <= 24-bit: no overflow
    return mid, side


def make_candidates(x: torch.Tensor) -> torch.Tensor:
    """[F, C, S] -> [F, C2, S] with mid and side rows appended per pair."""
    C = x.shape[1]
    extras = []
    for p in range(C // 2):
        m, s = _mid_side(x[:, 2 * p], x[:, 2 * p + 1])
        extras += [m[:, None], s[:, None]]
    return torch.cat([x, *extras], dim=1) if extras else x


def _render_rows(xb: torch.Tensor, q: torch.Tensor, order: torch.Tensor,
                 nv: torch.Tensor, rice_k_max: int) -> dict:
    """Normative render of [B, S] rows with chosen (order, q): K1 integer
    Levinson -> K5 FIR residues, guard and residue bit counts -> one K6
    call for the residue and coefficient blocks together (the JAX
    _render_rows, residue_partition=1). Returns per-row arrays, with
    block_bits = padded-word bits of both blocks (the exact mid/side rule's
    metric)."""
    c = lpc_from_q(q, order)
    e, eff_order, counts_res = fir_rice(xb, c, order, nv)
    cols = torch.arange(MAX_ORDER, device=q.device)[None, :]
    q_eff = torch.where(cols < eff_order[:, None], q, 0)
    # q_eff is zero from eff_order on, so its codes need no further mask
    counts_coeff = bit_counts(zigzag(q_eff))
    B = xb.shape[0]
    k_all, bits_all = ksel(torch.cat([counts_res, counts_coeff]),
                           torch.cat([nv, eff_order]), rice_k_max)
    nw_res = block_words(bits_all[:B])
    nw_coeff = block_words(bits_all[B:])
    return dict(e=e, eff_order=eff_order, q_eff=q_eff, k_res=k_all[:B],
                kr4=torch.zeros_like(eff_order), k_coeff=k_all[B:],
                nw_res=nw_res, nw_coeff=nw_coeff,
                block_bits=32 * (nw_res + nw_coeff))


def encode_step(x: torch.Tensor, n_valid: torch.Tensor, allow_ms: bool = True,
                max_order: int = MAX_ORDER, rice_k_max: int | None = None,
                partition: int = 1, ms_mode: str = "est") -> dict:
    """Full encode analysis and render for one chunk, on x's device.

    x: [F, C, S] int16 or int32 zero-padded PCM, n_valid: [F] int32.
    allow_ms=False disables the mid/side candidates (required for 32-bit
    PCM, FORMAT.md). ms_mode "est" (BitstreamProfile mid_side="auto")
    decides each pair from the cost that order selection models and renders
    the C winner rows only; "exact" renders every candidate and compares
    padded-word bits, the oracle's rule. partition=4 (partitioned residues)
    needs the K8 kernel, which is not ported yet, and raises.

    Returns the JAX encode_step's dict: residues [F, C, S] int32, res16
    [F, C, S] int16, fits16 [F] int32, order, k_res, k_res4, k_coeff,
    nw_res, nw_coeff, sftype [F, C] int32 and qcoeffs [F, C, 32] int32.
    """
    if partition != 1:
        raise NotImplementedError(
            "residue_partition=4 needs the quarter-counts kernel (K8, "
            "sela_tpu/kernels/encode.py::_quarter_counts_kernel), which the "
            "port does not have yet")
    if ms_mode not in ("est", "exact"):
        raise ValueError(f"ms_mode must be est|exact, got {ms_mode!r}")
    if rice_k_max is None:
        rice_k_max = RICE_K_MAX
    F, C, S = x.shape
    x = x.to(torch.int32)
    cand = make_candidates(x) if allow_ms else x
    C2 = cand.shape[1]
    xb = cand.reshape(F * C2, S).contiguous()
    nv = n_valid.to(torch.int32).repeat_interleave(C2)
    n_pairs = C // 2 if C2 > C else 0
    order, q, cost = analyze(xb, nv, max_order)

    if ms_mode == "est" and n_pairs:
        # analyze every candidate, render the winners only
        use_ms = _use_mid_side(cost.view(F, C2), C, n_pairs)
        # CHANNEL-MAJOR winner rows, as the JAX encode_step lays them out: a
        # pure row permutation, which changes no row's result
        r = _render_rows(_pick(cand, use_ms, C, 0).view(C * F, S),
                         _pick(q.view(F, C2, MAX_ORDER), use_ms, C, 0)
                         .view(C * F, MAX_ORDER),
                         _pick(order.view(F, C2), use_ms, C, 0).view(C * F),
                         n_valid.to(torch.int32).repeat(C), rice_k_max)

        def out(a):
            return a.view(C, F, *a.shape[1:]).transpose(0, 1)
    else:
        # the exact rule (also the path without pairs, where the two rules
        # agree): render every candidate, decide on padded-word bits
        r = _render_rows(xb, q, order, nv, rice_k_max)
        use_ms = _use_mid_side(r["block_bits"].view(F, C2), C, n_pairs)

        def out(a):
            return _pick(a.view(F, C2, *a.shape[1:]), use_ms, C, 1)

    sftype = []
    for c in range(C):
        if c // 2 < n_pairs:
            t = SF_MID if c % 2 == 0 else SF_SIDE
            sftype.append(torch.where(use_ms[c // 2], t, SF_DIRECT))
        else:
            sftype.append(torch.full((F,), SF_DIRECT, device=x.device))
    return _encode_outputs(
        out(r["e"]), out(r["eff_order"]), out(r["q_eff"]), out(r["k_res"]),
        out(r["kr4"]), out(r["k_coeff"]), out(r["nw_res"]), out(r["nw_coeff"]),
        torch.stack(sftype, dim=1).to(torch.int32))


def _use_mid_side(metric: torch.Tensor, C: int, n_pairs: int) -> list:
    """Per pair p, [F] bool: do its mid and side rows (C + 2p, C + 2p + 1)
    cost less than its direct rows (2p, 2p + 1) by `metric` [F, C2]?"""
    return [metric[:, C + 2 * p] + metric[:, C + 2 * p + 1]
            < metric[:, 2 * p] + metric[:, 2 * p + 1] for p in range(n_pairs)]


def _pick(a: torch.Tensor, use_ms: list, C: int, dim: int) -> torch.Tensor:
    """[F, C2, ...] candidate arrays -> the C chosen ones stacked on `dim`:
    output channel c takes its mid/side row C + c where its pair chose
    mid/side, else its direct row c (a where per channel, not a gather)."""
    cols = []
    for c in range(C):
        if c // 2 < len(use_ms):
            u = use_ms[c // 2].view(-1, *([1] * (a.dim() - 2)))
            cols.append(torch.where(u, a[:, C + c], a[:, c]))
        else:
            cols.append(a[:, c])
    return torch.stack(cols, dim=dim)


def _encode_outputs(res, order, qcoeffs, k_res, kr4, k_coeff, nw_res,
                    nw_coeff, sftype) -> dict:
    """Assemble encode_step's output dict from decided [F, C, ...] arrays."""
    # int16 wire for the device->host residue copy; the range check is
    # wrap-safe (abs(INT32_MIN) would wrap and pass as < 2^15)
    fits16 = ((res >= -(1 << 15)) & (res < (1 << 15))).all(dim=2).all(dim=1)
    return dict(residues=res, res16=res.to(torch.int16),
                fits16=fits16.to(torch.int32), order=order, qcoeffs=qcoeffs,
                k_res=k_res, k_res4=kr4, k_coeff=k_coeff, nw_res=nw_res,
                nw_coeff=nw_coeff, sftype=sftype)


def _inverse_mid_side(mid: torch.Tensor, side: torch.Tensor):
    left = mid + ((side + (side & 1)) >> 1)
    return left, left - side


def decode_step(residues: torch.Tensor, qcoeffs: torch.Tensor,
                order: torch.Tensor, sftype: torch.Tensor,
                out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Inverse of the encode step for one chunk: PCM [F, C, S] of out_dtype.

    residues may arrive as int16 (the host sends that wire dtype when every
    value fits); codec math is int32. out_dtype=torch.int16 halves the
    device->host transfer for <=16-bit streams.
    """
    F, C, S = residues.shape
    B = F * C
    # CHANNEL-MAJOR rows, as the JAX decode_step lays them out: the row
    # order does not change any row's result
    q_cm = qcoeffs.transpose(0, 1).reshape(B, -1).to(torch.int32).contiguous()
    o_cm = order.transpose(0, 1).reshape(B).to(torch.int32).contiguous()
    c = lpc_from_q(q_cm, o_cm)
    e = residues.transpose(0, 1).reshape(B, S).to(torch.int32).contiguous()
    xc = iir_synthesize(e, c).view(C, F, S)
    # inverse mid/side fused with the channel-major -> [F, C, S] restore:
    # one where per output channel and one stack
    chans = []
    for p in range(C // 2):
        li, ri = 2 * p, 2 * p + 1
        is_ms = (sftype[:, li] == SF_MID)[:, None]
        left, right = _inverse_mid_side(xc[li], xc[ri])
        chans.append(torch.where(is_ms, left, xc[li]))
        chans.append(torch.where(is_ms, right, xc[ri]))
    if C % 2:
        chans.append(xc[C - 1])
    return torch.stack(chans, dim=1).to(out_dtype)
