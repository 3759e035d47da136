"""LPC analysis + integer-exact prediction filters — numpy oracle.

Capability parity target: upstream:src/lpc/residue_generator.cpp,
linear_predictor.cpp, sample_generator.cpp (sahaRatul/sela, path-level cite —
mount empty, SURVEY.md SS2).

The float analysis half (autocorrelation -> Levinson-Durbin -> order choice ->
coefficient quantization) is NON-normative: encoders may differ. Everything
from quantized reflection coefficients onward (dequantize -> integer Levinson
-> Q20 prediction) is NORMATIVE integer math per FORMAT.md and must be
bit-identical across implementations.
"""
from __future__ import annotations

import numpy as np

from ..format import (
    COEFF_BIT_COST,
    MAX_ORDER,
    ORDER_QNOISE_PENALTY,
    Q_CLAMP_HI,
    Q_CLAMP_LO,
    REF_Q,
    RESIDUE_LIMIT,
)

I32_MIN = -(1 << 31)
I32_MAX = (1 << 31) - 1


# ---------------------------------------------------------------- analysis --

def autocorr(x: np.ndarray, max_lag: int = MAX_ORDER) -> np.ndarray:
    """Autocorrelation r[0..max_lag] of int32 samples, float64."""
    xf = np.asarray(x, dtype=np.float64)
    n = len(xf)
    r = np.zeros(max_lag + 1, dtype=np.float64)
    for lag in range(min(max_lag, n - 1) + 1):
        r[lag] = np.dot(xf[: n - lag], xf[lag:])
    return r


def levinson_reflection(r: np.ndarray, order: int = MAX_ORDER):
    """Levinson-Durbin: returns (reflection gamma[1..order], err[0..order])."""
    gamma = np.zeros(order, dtype=np.float64)
    err = np.zeros(order + 1, dtype=np.float64)
    err[0] = r[0]
    if r[0] <= 0:
        return gamma, err
    a = np.zeros(order + 1, dtype=np.float64)
    e = r[0]
    for m in range(1, order + 1):
        acc = r[m] - np.dot(a[1:m], r[1:m][::-1])
        k = acc / e if e > 0 else 0.0
        k = float(np.clip(k, -0.999999, 0.999999))
        gamma[m - 1] = k
        a[1:m] = a[1:m] - k * a[1:m][::-1]
        a[m] = k
        e = e * (1.0 - k * k)
        err[m] = e
    return gamma, err


def select_order(err: np.ndarray, n_samples: int) -> int:
    """argmin over m of N/2 * log2(err_m + m*LAM*r0) + COEFF_BIT_COST * m.

    The m*LAM*r0 term models the residual noise added by 7-bit coefficient
    quantization (LAM = quantizer step^2 = 2^-12), which the float Levinson
    err ignores — without it the model overshoots the true optimal order by
    ~6 on musical content (format.ORDER_QNOISE_PENALTY, RATIO_SWEEP.json).
    """
    tiny = 1e-9
    m = np.arange(len(err))
    adj = err + ORDER_QNOISE_PENALTY * m * err[0]
    cost = 0.5 * n_samples * np.log2(np.maximum(adj, tiny)) + COEFF_BIT_COST * m
    return int(np.argmin(cost))


def quantize_reflection(gamma: np.ndarray) -> np.ndarray:
    """Companded 7-bit quantization of reflection coefficients (sela/ALS-style).

    q_1 = floor(64*(sqrt(2*(g+1)) - 1)); q_2 = floor(64*(sqrt(2*(1-g)) - 1));
    q_m = floor(64*g) for m >= 3. Clamped to [-64, 63].
    """
    g = np.asarray(gamma, dtype=np.float64)
    q = np.empty(len(g), dtype=np.int32)
    if len(g) >= 1:
        q[0] = np.floor(64.0 * (np.sqrt(2.0 * (g[0] + 1.0)) - 1.0))
    if len(g) >= 2:
        q[1] = np.floor(64.0 * (np.sqrt(2.0 * (1.0 - g[1])) - 1.0))
    if len(g) > 2:
        q[2:] = np.floor(64.0 * g[2:]).astype(np.int32)
    return np.clip(q, Q_CLAMP_LO, Q_CLAMP_HI).astype(np.int32)


# ------------------------------------------------------- normative integer --

def dequantize_reflection(q: np.ndarray) -> np.ndarray:
    """Quantized ints -> Q20 reflection coefficients (int64). NORMATIVE.

    m=1: g = 128*(q+64)^2 - 2^20
    m=2: g = 2^20 - 128*(q+64)^2
    m>=3: g = q * 16384
    """
    q = np.asarray(q, dtype=np.int64)
    g = q * 16384
    if len(q) >= 1:
        g[0] = 128 * (q[0] + 64) ** 2 - (1 << REF_Q)
    if len(q) >= 2:
        g[1] = (1 << REF_Q) - 128 * (q[1] + 64) ** 2
    return g


def _rshift_round(v: np.ndarray | int, s: int):
    """(v + 2^(s-1)) >> s with arithmetic (floor) shift. NORMATIVE."""
    return (v + (1 << (s - 1))) >> s


COEFF_SAT_LO = -(1 << 23)
COEFF_SAT_HI = (1 << 23) - 1


def reflection_to_lpc(g_q20: np.ndarray) -> np.ndarray:
    """Integer Levinson recursion: Q20 reflection -> Q20 direct-form coeffs.

    int64 arithmetic, saturated to [-2^23, 2^23-1] after EVERY step — bounds
    all products to 2^44 (no overflow anywhere) and licenses the limb-split
    decode kernels' 12/13-bit limb decomposition (FORMAT.md). NORMATIVE.
    """
    g = np.asarray(g_q20, dtype=np.int64)
    p = len(g)
    a = np.zeros(0, dtype=np.int64)  # values always within the SAT bound
    for m in range(1, p + 1):
        k = g[m - 1]
        new_a = np.empty(m, dtype=np.int64)
        if m > 1:
            new_a[: m - 1] = np.clip(
                a - _rshift_round(k * a[::-1], REF_Q), COEFF_SAT_LO, COEFF_SAT_HI
            )
        new_a[m - 1] = k
        a = new_a
    return a.astype(np.int32)


def fir_residues(x: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """e[n] = x[n] - rshift(sum_j c_j*x[n-j], Q), zero-padded history. NORMATIVE."""
    x = np.asarray(x, dtype=np.int64)
    c = np.asarray(coeffs, dtype=np.int64)
    n = len(x)
    acc = np.zeros(n, dtype=np.int64)
    for j in range(1, len(c) + 1):
        acc[j:] += c[j - 1] * x[: n - j]
    pred = _rshift_round(acc, REF_Q)
    return x - pred  # int64; caller checks RESIDUE_LIMIT


def iir_synthesize(e: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """x[n] = e[n] + rshift(sum_j c_j*x[n-j], Q) — sequential. NORMATIVE."""
    e = np.asarray(e, dtype=np.int64)
    c = np.asarray(coeffs, dtype=np.int64)
    p = len(c)
    n = len(e)
    if p == 0:
        return e.astype(np.int32)
    hist = np.zeros(p, dtype=np.int64)  # hist[0] = x[n-1], ... hist[p-1] = x[n-p]
    x = np.empty(n, dtype=np.int64)
    half = 1 << (REF_Q - 1)
    for i in range(n):
        acc = int(np.dot(c, hist))
        x[i] = e[i] + ((acc + half) >> REF_Q)
        hist[1:] = hist[:-1]
        hist[0] = x[i]
    return x.astype(np.int32)


# ----------------------------------------------------------------- plan API --

def analyze_channel(x: np.ndarray,
                    max_order: int = MAX_ORDER) -> tuple[int, np.ndarray]:
    """Float analysis for one channel signal: returns (order, qcoeffs[order])."""
    n = len(x)
    if n == 0:
        return 0, np.zeros(0, dtype=np.int32)
    r = autocorr(x, max_order)
    gamma, err = levinson_reflection(r, max_order)
    order = select_order(err, n)
    q = quantize_reflection(gamma[:order])
    return order, q


def render_channel(x: np.ndarray, order: int, qcoeffs: np.ndarray):
    """Deterministic core: (order, qcoeffs) -> (order', qcoeffs', residues).

    Falls back to order 0 if residues exceed RESIDUE_LIMIT. NORMATIVE given
    its inputs.
    """
    x = np.asarray(x, dtype=np.int32)
    if order == 0:
        return 0, np.zeros(0, dtype=np.int32), x.copy()
    g = dequantize_reflection(qcoeffs[:order])
    c = reflection_to_lpc(g)
    e = fir_residues(x, c)
    if np.any(np.abs(e) >= RESIDUE_LIMIT):
        return 0, np.zeros(0, dtype=np.int32), x.copy()
    return order, np.asarray(qcoeffs[:order], dtype=np.int32), e.astype(np.int32)


def reconstruct_channel(residues: np.ndarray, order: int, qcoeffs: np.ndarray):
    """Decode-side mirror of render_channel. NORMATIVE."""
    if order == 0:
        return np.asarray(residues, dtype=np.int32).copy()
    g = dequantize_reflection(qcoeffs[:order])
    c = reflection_to_lpc(g)
    return iir_synthesize(residues, c)
