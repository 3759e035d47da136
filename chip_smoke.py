#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`sela_tpu_torch`) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. device  — require CUDA, print the card's name, count, power limit and
             maximum SM clock;
2. build   — build the seven CUDA kernel libraries and the native bit I/O
             library from this checkout's sources, all compilers started
             together; print the build seconds, what `-Xptxas -v` says and
             each library's static SASS instruction mix (`cuobjdump`);
3. K1      — the LPC kernel (csrc/lpc.cu) against its plain PyTorch version
             on the card, exactly: at 1,024 and 7,752 rows with mixed orders
             (timed at 1,024), and with q = -64 and q = 63 at order 32 on
             every row; then a sweep of 1 to 16,896 rows at order 32, time
             against rows;
4. IIR     — the IIR kernel (csrc/iir.cu) against its plain version on the
             card, exactly: (a) [1,024, 2,048] residues rendered by the
             oracle from synthetic music, orders 0..32 mixed in every block
             (timed); (b) the same shape with uniform random int32 residues,
             whose synthesis wraps (the K7 contract); (c) a sweep of 1 to
             16,896 rows at order 32, time against rows; (d) the edges: 1,027
             rows (not a multiple of a block's rows) at N = 1, 31, 32, 33,
             1,000 and 2,047, with rows whose only coefficient is c_32 and
             rows of 32 coefficients of +-2^23, under small and wrapping
             residues;
5. K5, K6  — FIR + Rice bit counts (csrc/fir_rice.cu) at [1,024, 2,048] on
             the CD track's frames (orders 0..32, tails, rows that trip the
             residue guard and rows on its edges) and the Rice k selection
             (csrc/ksel.cu) at 2,048 rows (K5's counts, random and
             escape-forcing counts; k_max 30, 7, 0), exactly;
5b. K8, K6 — the per-quarter bit counts (csrc/quarter_counts.cu) at [1,024,
             2,048], exactly: (a) phase 5's K5 residues with n_valid 2,048,
             2,000, 7, 5, 4, 3, 1 and 0 on some rows, (b) uniform int32
             residues holding INT32_MIN and INT32_MAX, (c) the edges: 1,027
             rows with n_valid 1, 3, 4, 5, 127, 128, 129, 2,047, 2,048 and 0,
             whose widest zigzag code has 1, 31 and 32 bits; timed and
             bounded on (a)'s residues at phase 5's n_valid, warm (L2) and
             cold (input rotated over 7 copies), and at 1, 132 and 1,024
             rows; then K6 at its v2 shape, 6,144 rows (K5's counts, the
             coefficient counts and K8's quarters of (a)), exactly;
6. K3, K4  — autocorrelation (csrc/autocorr.cu) and Levinson / order
             selection (csrc/levinson.cu) at the main path's [2,048, 2,048]
             candidate rows of the CD track: K3 within 1e-5 of r[0] a row
             (and the conv1d yardstick with it), also on the edges (1,027
             rows at N = 1, 31, 32, 33, 255, 256, 257 and 2,047 with
             all-zero, INT32_MIN and +-(2^24 - 1) rows), timed warm and
             cold (4 copies) and at 1, 132 and 2,048 rows; K4 given K3's r
             identical in order and q on every row;
7. decode  — encode with the port's oracle and decode with
             `sela_tpu_torch.codec.decoder.decode_sela` on the card: a 3-minute
             16-bit/44.1 kHz stereo track (the decode main path), a 30 s
             24-bit/96 kHz clip and a 10 s 32-bit clip holding INT32_MIN and
             INT32_MAX; the PCM must equal the input and K1 and the IIR kernel
             must have run; one profiled decode of the CD track gives the
             device busy time (every profiled run also lists the device time
             of each of the port's kernels);
8. encode  — `sela_tpu_torch.codec.encoder.encode_wav` on the card (the
             encode main path) on the same three clips: each stream decodes
             on the card to the input (the 32-bit one through the oracle as
             well), K1, K3, K4, K5 and K6 must have run once a chunk and K8
             never, and the CD stream may be at most 1% larger than the
             oracle's; one profiled encode gives the device busy time;
9. encode v2 — `encode_wav` with partitioned residues (residue_partition=4)
             on the card: the CD track, whose stream may be no larger than
             the v1 stream of phase 8, and a 20 s 16-bit/44.1 kHz percussive
             clip, whose v2 stream must be more than 1% smaller than its v1
             stream and at most 1% larger than the oracle's v2 stream, and
             must decode to the input through the oracle too; K8 and K6 run
             once a chunk; one profiled encode of each clip;
10. each kernel's share of its bound, the `kernels` JSON line, then the
   card's name and power limit, then the last line
   `{"ok": true, "device": {...}}`.

Comparisons of the normative integer kernels are exact (max_abs_err 0); K3's
tolerance and K4's rule are stated in phase 6. Kernel times are CUDA-event
times of many back-to-back launches queued behind a device-side sleep, so
host launch overhead is not in them; "warm" times find the input in the L2
cache (back to back on one input), "cold" ones rotate over copies that
together exceed it. A kernel's share is its bound over its time.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM, and 67
# TFLOP/s of float32 outside the tensor cores with an FMA counted as two,
# i.e. 33.5e12 lane-instructions a second. Integer work is counted in int32
# lane-instructions at that rate; a 32x32->64 multiply-add into a 64-bit sum
# counts 4 (the wide product 2, the carried 64-bit add 2).
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 2
FLOPS_PER_S = 67e12                 # float32, an FMA counted as two
MAC64_OPS = 4
LEVINSON_STEP_OPS = MAC64_OPS + 6   # + round, shift, subtract, clamp (64-bit)
IIR_SAMPLE_OPS = 4                  # round, shift, low-32 add of e per sample
FIR_SAMPLE_OPS = 10                 # round, shift, subtract (64-bit), guard,
                                    # select, zigzag per valid sample
BITCOUNT_OPS = 2                    # shift-and + add per bit a sample counts
QUARTER_SAMPLE_OPS = 8              # zigzag (3), quarter index (3 compares,
                                    # 2 adds) per valid sample
KSEL_STEP_OPS = 8                   # 64-bit shift-add, cost, compare, select

FRAME = 2048
ROWS_MAIN = 1024    # rows of one default 512-frame stereo chunk
ROW_SWEEP = (1, 128, ROWS_MAIN, 4096, 16896)   # K1 and IIR time against rows
CAND_MAIN = 2048    # its L, R, mid and side candidate rows (K3, K4)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ------------------------------------------------------------ test signals --

def make_track(seconds: float, rate: int, bits: int, seed: int) -> list[np.ndarray]:
    """Synthetic stereo music at `bits` from a seed.

    Notes of 0.5-2 s: a fundamental with vibrato and 1-10 harmonics under an
    attack/decay envelope at a per-note level, plus AR noise of a per-note
    level and colour (0 to 16 resonances). The right channel mixes the left's
    music with an independent voice at a per-note weight, so both mid/side
    and direct frames occur, and the mix of tonal and noisy notes spreads the
    chosen LPC orders from 0 to 32."""
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    n = int(round(seconds * rate))
    bounds = [0]
    while bounds[-1] < n:
        bounds.append(bounds[-1] + int(rng.uniform(0.5, 2.0) * rate))
    bounds[-1] = n
    idx = np.repeat(np.arange(len(bounds) - 1), np.diff(bounds))
    k = len(bounds) - 1
    t_note = (np.arange(n) - np.asarray(bounds[:-1])[idx]) / rate
    t = np.arange(n) / rate

    def voice(f0, n_harm, decay):
        vib = 1.0 + 0.006 * np.sin(2 * np.pi * 5.5 * t)
        phase = 2 * np.pi * np.cumsum(f0[idx] * vib) / rate
        env = (1 - np.exp(-t_note * 60.0)) * np.exp(-t_note * decay[idx])
        out = np.zeros(n)
        for h in range(1, 11):
            amp = np.where(h <= n_harm[idx], 0.7 ** (h - 1), 0.0)
            out += amp * np.sin(h * phase + h)
        return out * env

    def pick_f0():
        return 55.0 * 2 ** (rng.integers(0, 48, k) / 12)

    music = voice(pick_f0(), rng.integers(1, 11, k), rng.uniform(0.2, 3.0, k))
    other = voice(pick_f0(), rng.integers(1, 11, k), rng.uniform(0.2, 3.0, k))
    gain = 10.0 ** rng.uniform(-2.0, 0.0, k)          # music level per note
    level = 10.0 ** rng.uniform(-3.5, -0.5, k)        # noise level per note
    n_res = rng.choice([0, 1, 2, 4, 8, 12, 16], k)    # noise resonances
    bare = rng.random(k) < 0.1                        # white noise alone
    gain[bare], n_res[bare] = 0.0, 0

    def noise():
        out = rng.standard_normal(n)
        for j in range(k):   # AR(2 n_res) noise: resonances near the unit circle
            a, b = bounds[j], bounds[j + 1]
            poles = rng.uniform(0.95, 0.999, n_res[j]) * np.exp(
                1j * rng.uniform(0.05, 3.0, n_res[j]))
            den = np.real(np.poly(np.concatenate([poles, poles.conj()])))
            seg = lfilter([1.0], den, out[a:b])
            out[a:b] = seg / max(seg.std(), 1e-9) * level[j]
        return out

    w = rng.choice([0.0, 0.05, 0.4, 1.0], k)          # right = left .. other
    g = gain[idx]
    left = 0.35 * g * music + noise()
    right = 0.35 * g * ((1 - w[idx]) * music + w[idx] * other) + noise()
    full = (1 << (bits - 1)) - 1
    chans = []
    for x in (left, right):
        x = np.round(x / max(np.abs(x).max(), 1e-9) * 0.8 * full)
        chans.append(np.clip(x, -full - 1, full).astype(np.int32))
    return chans


def make_percussive(seconds: float, seed: int) -> list[np.ndarray]:
    """Drum-like 16-bit/44.1 kHz stereo from a seed (the generator of
    tests/test_partition.py::percussive_wav): a decaying two-tone hit every
    0.12 s under noise that swells with each hit; the right channel is the
    left 31 samples later at 0.94. Its residues change scale within a frame,
    which is what partitioned residues are for."""
    rng = np.random.default_rng(seed)
    rate = 44100
    n = int(rate * seconds)
    t = np.arange(n) / rate
    env = np.zeros(n)
    period = int(0.12 * rate)
    for s in range(0, n, period):
        L = min(period, n - s)
        env[s : s + L] = np.exp(-np.arange(L) / (0.015 * rate))
    sig = env * (np.sin(2 * np.pi * 180 * t) + 0.5 * np.sin(2 * np.pi * 923 * t))
    sig = sig * 24000 + rng.normal(0, 120, n) * (0.15 + env)
    return [np.clip(np.round(x), -32767, 32767).astype(np.int32)
            for x in (sig, np.roll(sig, 31) * 0.94)]


# ---------------------------------------------------------------- timing --

def time_kernel(torch, fn, iters: int) -> float:
    """Device ms per call of `fn`: `iters` calls queued behind a device-side
    sleep, so the launches run back to back whatever the host overhead."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)   # ~25 ms at 2 GHz: covers the enqueue
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_kernel_cold(torch, fn, inputs: list, iters: int) -> float:
    """Device ms per call of `fn(inp)` with the input rotated over `inputs`,
    copies enough to exceed the 50 MB L2 between two uses of one copy, so
    each call reads its input from HBM as a caller with a cold cache would."""
    it = iter(range(1 << 30))
    return time_kernel(torch, lambda: fn(inputs[next(it) % len(inputs)]), iters)


def share(bound: float, ms: float) -> float:
    """The kernel's share of its bound: bound time over measured time."""
    return bound / ms if ms > 0 else 0.0


def time_plain(torch, fn, iters: int) -> float:
    """ms per call of a plain PyTorch version, host dispatch included (it is
    many small operations; that is its real cost)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound_ms(nbytes: float, ops: float,
             rate: float = INT_OPS_PER_S) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def lpc_bound(order: np.ndarray) -> tuple[float, str]:
    """K1 on these rows: reads q and order, writes c; the Levinson steps
    that the rows' orders need."""
    B = len(order)
    o = order.astype(np.int64)
    steps = (o * (o - 1) // 2).sum()   # sum over m <= order of (m - 1)
    return bound_ms(B * (32 * 4 + 4 + 32 * 4), steps * LEVINSON_STEP_OPS)


def iir_bound(order: np.ndarray, n: int) -> tuple[float, str]:
    """IIR on these rows: reads e and c, writes x; order taps a sample."""
    B = len(order)
    ops = (order.astype(np.int64).sum() * MAC64_OPS + B * IIR_SAMPLE_OPS) * n
    return bound_ms(B * (n * 4 + 32 * 4 + n * 4), ops)


def fir_rice_bound(c: np.ndarray, nv: np.ndarray, e: np.ndarray):
    """K5 on these rows: reads x up to n_valid, c, order and n_valid, writes
    e (the whole row), eff_order and counts. Per valid sample: a 64-bit
    multiply-add per tap below the row's highest nonzero coefficient, the
    epilogue, and a shift-and-add per bit up to the row's widest zigzag code
    (higher counts are zero)."""
    B, N = e.shape
    nz = c != 0
    taps = np.where(nz.any(axis=1), 32 - np.argmax(nz[:, ::-1], axis=1), 0)
    valid = np.clip(nv.astype(np.int64), 0, N)
    ops = (valid * (MAC64_OPS * taps + FIR_SAMPLE_OPS
                    + BITCOUNT_OPS * zigzag_widths(e, valid))).sum()
    return bound_ms(valid.sum() * 4 + B * (N * 4 + 2 * 32 * 4 + 3 * 4), ops)


def zigzag_widths(e: np.ndarray, nv: np.ndarray) -> np.ndarray:
    """Bits of each row's widest zigzag code among its first nv samples."""
    N = e.shape[1]
    e64 = e.astype(np.int64)
    u = np.where(np.arange(N)[None, :] < nv[:, None], (e64 << 1) ^ (e64 >> 63), 0)
    return np.array([int(m).bit_length() for m in u.max(axis=1)])


def quarter_counts_bound(e: np.ndarray, nv: np.ndarray) -> tuple[float, str]:
    """K8 on these rows: reads e up to n_valid (the counts do not depend on
    what lies past it) and n_valid, writes [4, 32] counts a row. Per valid
    sample: the zigzag and the quarter index, and a shift-and-add per bit up
    to the row's widest zigzag code (higher counts are zero)."""
    B, N = e.shape
    valid = np.clip(nv.astype(np.int64), 0, N)
    ops = (valid * (QUARTER_SAMPLE_OPS
                    + BITCOUNT_OPS * zigzag_widths(e, valid))).sum()
    return bound_ms(valid.sum() * 4 + B * (4 + 4 * 32 * 4), ops)


def ksel_bound(B: int) -> tuple[float, str]:
    """K6: reads counts and n, writes k and bits; 31 recurrence steps."""
    return bound_ms(B * (32 * 4 + 3 * 4), B * 31 * KSEL_STEP_OPS)


def autocorr_bound(B: int, N: int) -> tuple[float, str]:
    """K3: reads x, writes r; 33 float multiply-adds a sample."""
    return bound_ms(B * (N * 4 + 33 * 4), B * N * 33 * 2, FLOPS_PER_S)


def levinson_bound(B: int) -> tuple[float, str]:
    """K4: reads r and n, writes order, q and cost; per row the 32 steps'
    dot products and updates (4(m-1) + 12 flops at step m) and 33 costs,
    a logarithm counted as 20 flops."""
    flops = sum(4 * (m - 1) + 12 for m in range(1, 33)) + 33 * (20 + 6)
    return bound_ms(B * (33 * 4 + 4 + 4 + 32 * 4 + 4), B * flops, FLOPS_PER_S)


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


# ---------------------------------------------------------------- phases --

def phase_device(torch) -> tuple[str, str]:
    log("== phase 1: device")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"device: {kind} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; max SM clock {clock}")
    log(smi)
    return kind, smi


def sass_mix(cuobjdump: str, lib: str) -> str:
    """The static instruction mix of a library's kernels, from
    `cuobjdump -sass`: the ten most frequent opcodes (modifiers dropped)."""
    import re
    from collections import Counter

    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, timeout=120).stdout
    ops = Counter(m.group(1).split(".")[0] for m in re.finditer(
        r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", sass))
    return ", ".join(f"{op} {n}" for op, n in ops.most_common(10))


def phase_build(k_lpc, k_iir, k_enc, bitio, build_log, build_dir,
                nvcc) -> None:
    log("== phase 2: build")

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    jobs = {"sela_lpc": k_lpc.load, "sela_iir": k_iir.load,
            "selabitio": bitio.load}
    for kernel, spec in k_enc.KERNELS.items():
        jobs[spec[0]] = (lambda kernel=kernel: k_enc.load(kernel))
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {name: ex.submit(timed, fn) for name, fn in jobs.items()}
        secs = {name: f.result() for name, f in futs.items()}
    log(f"built in {time.perf_counter() - t0:.1f} s (in parallel): "
        + ", ".join(f"lib{k}.so {v:.1f} s" for k, v in secs.items()))
    cuobjdump = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    for name in jobs:   # -Xptxas -v: registers, shared memory, spills
        if name == "selabitio":
            continue
        for line in build_log(name).splitlines():
            if line.strip():
                log(f"  {name}: {line.strip()}")
        if os.path.exists(cuobjdump):
            log(f"  {name} SASS (static counts): "
                f"{sass_mix(cuobjdump, os.path.join(build_dir, f'lib{name}.so'))}")


def phase_lpc(torch, ops_coeffs) -> dict:
    log("== phase 3: K1 (lpc_from_q) against its plain version")
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")

    def compare(q, order):
        qd = torch.from_numpy(q).to(dev)
        od = torch.from_numpy(order).to(dev)
        got = ops_coeffs.lpc_from_q(qd, od)
        want = ops_coeffs.lpc_from_q_reference(qd, od)
        torch.cuda.synchronize()
        return qd, od, max_abs_err(got, want), bool(torch.equal(got, want))

    result = {}
    for B in (ROWS_MAIN, 7752):
        order = rng.permutation(np.arange(B) % 33).astype(np.int32)
        q = rng.integers(-64, 64, (B, 32)).astype(np.int32)
        q.reshape(-1)[: 128 * 4] = np.tile(np.arange(-64, 64), 4)  # every q
        qd, od, err, exact = compare(q, order)
        for q_edge in (-64, 63):   # the extreme reflections at full order
            _, _, err_e, exact_e = compare(np.full((B, 32), q_edge, np.int32),
                                           np.full(B, 32, np.int32))
            log(f"B={B} q={q_edge} order 32: exact={exact_e} "
                f"max_abs_err={err_e}")
            check(exact_e, f"K1 disagrees at B={B}, q={q_edge}, order 32")
            err = max(err, err_e)
        ms = time_kernel(torch, lambda: ops_coeffs.lpc_from_q(qd, od), 200)
        plain = time_plain(torch,
                           lambda: ops_coeffs.lpc_from_q_reference(qd, od), 5)
        bms, by = lpc_bound(order)
        log(f"B={B}: exact={exact} max_abs_err={err} kernel {ms:.5f} ms, "
            f"plain {plain:.3f} ms, bound {bms:.5f} ms ({by})")
        check(exact, f"K1 disagrees with its plain version at B={B}")
        result[B] = dict(max_abs_err=err, exact=exact, ms=ms, plain_ms=plain,
                         bound_ms=bms, bound_by=by)

    # time against rows at order 32 (B = 1 is one row's chain and the launch)
    sweep = {}
    for B in ROW_SWEEP:
        order = np.full(B, 32, np.int32)
        qd, od, err, exact = compare(
            rng.integers(-64, 64, (B, 32)).astype(np.int32), order)
        check(exact, f"K1 disagrees with its plain version at B={B}")
        sweep[B] = time_kernel(torch, lambda: ops_coeffs.lpc_from_q(qd, od), 50)
        log(f"rows {B} (order 32): exact={exact} kernel {sweep[B]:.5f} ms, "
            f"bound {lpc_bound(order)[0]:.6f} ms")
    return dict(result[ROWS_MAIN], rows_ms=sweep)


def oracle_rows(ref_lpc, chans: list[np.ndarray], B: int, rng):
    """B frames of real-ish audio rendered by the oracle: analysis at order
    32, then each row cut to its own order (r mod 33, so every block mixes
    orders 0..32). Returns (x, e, q, order) with the oracle's fallback
    (order 0 when a residue would exceed the limit) applied."""
    n_frames = len(chans[0]) // FRAME
    starts = rng.choice(n_frames, B // 2, replace=False) * FRAME
    xs, es, qs, orders = [], [], [], []
    for r in range(B):
        x = chans[r % 2][starts[r // 2] : starts[r // 2] + FRAME]
        gamma, _ = ref_lpc.levinson_reflection(ref_lpc.autocorr(x, 32), 32)
        order, q, e = ref_lpc.render_channel(
            x, r % 33, ref_lpc.quantize_reflection(gamma))
        qrow = np.zeros(32, np.int32)
        qrow[:order] = q
        xs.append(x), es.append(e), qs.append(qrow), orders.append(order)
    return (np.stack(xs), np.stack(es), np.stack(qs),
            np.asarray(orders, np.int32))


def phase_iir(torch, ops_coeffs, filters, k_iir, rows, rng) -> dict:
    log("== phase 4: IIR kernel against its plain version")
    dev = torch.device("cuda")
    x, e, q, order = rows
    log(f"(a) oracle residues: orders {np.bincount(order, minlength=33).tolist()}")
    c = ops_coeffs.lpc_from_q_reference(torch.from_numpy(q),
                                        torch.from_numpy(order))
    ed, cd = torch.from_numpy(e).to(dev), c.to(dev)
    got = k_iir.iir_synthesize(ed, cd)
    want = filters.iir_synthesize_reference(ed, cd)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    exact = bool(torch.equal(got, want))
    inverts = bool(np.array_equal(got.cpu().numpy(), x))
    ms = time_kernel(torch, lambda: k_iir.iir_synthesize(ed, cd), 20)
    plain = time_plain(torch,
                       lambda: filters.iir_synthesize_reference(ed, cd), 1)
    bms, by = iir_bound(order, FRAME)
    log(f"(a) [{ROWS_MAIN}, {FRAME}]: exact={exact} max_abs_err={err} "
        f"inverts_fir={inverts} kernel {ms:.4f} ms, plain {plain:.1f} ms, "
        f"bound {bms:.5f} ms ({by})")
    check(exact and inverts, "IIR kernel disagrees on oracle residues")

    # (b) uniform int32 residues under valid coefficients: x wraps mod 2^32
    order_b = rng.permutation(np.arange(ROWS_MAIN) % 33).astype(np.int32)
    q_b = rng.integers(-64, 64, (ROWS_MAIN, 32)).astype(np.int32)
    c_b = ops_coeffs.lpc_from_q_reference(torch.from_numpy(q_b),
                                          torch.from_numpy(order_b)).to(dev)
    e_b = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (ROWS_MAIN, FRAME),
                                        dtype=np.int64).astype(np.int32)).to(dev)
    got_b = k_iir.iir_synthesize(e_b, c_b)
    want_b = filters.iir_synthesize_reference(e_b, c_b)
    torch.cuda.synchronize()
    err_b = max_abs_err(got_b, want_b)
    exact_b = bool(torch.equal(got_b, want_b))
    log(f"(b) random int32 residues: exact={exact_b} max_abs_err={err_b}")
    check(exact_b, "IIR kernel disagrees on wrapping int32 residues")

    # (c) time against the row count at order 32 (B = 1 is one row's chain;
    # 16,896 rows put 128 warps on each of 132 SMs)
    sweep = {}
    for B in ROW_SWEEP:
        qs = torch.from_numpy(rng.integers(-64, 64, (B, 32)).astype(np.int32))
        ords = torch.from_numpy(np.full(B, 32, np.int32))
        cs = ops_coeffs.lpc_from_q_reference(qs, ords).to(dev)
        es = torch.from_numpy(rng.integers(-4096, 4096, (B, FRAME))
                              .astype(np.int32)).to(dev)
        sweep[B] = time_kernel(torch, lambda: k_iir.iir_synthesize(es, cs), 10)
        log(f"(c) rows {B}: iir {sweep[B]:.4f} ms "
            f"({sweep[B] * 1e6 / (B * FRAME):.3f} ns a row-sample), bound "
            f"{iir_bound(np.full(B, 32), FRAME)[0]:.5f} ms")

    # (d) the edges: ragged tiles and blocks, the history reaching a whole
    # tile back (c_32 alone), |c| = 2^23 on every tap, wrapping residues
    B = 1027
    errs_d, exact_d = [], True
    for n in (1, 31, 32, 33, 1000, FRAME - 1):
        for lim in (1 << 12, 1 << 31):
            order_d = rng.permutation(np.arange(B) % 33).astype(np.int32)
            q_d = rng.integers(-64, 64, (B, 32)).astype(np.int32)
            c_d = ops_coeffs.lpc_from_q_reference(
                torch.from_numpy(q_d), torch.from_numpy(order_d)).numpy()
            c_d[1::16] = 0
            c_d[1::16, 31] = rng.integers(-(1 << 23), (1 << 23) + 1,
                                          len(c_d[1::16]))
            c_d[1:49:16, 31] = (1 << 23, -(1 << 23), 1)
            c_d[2::16] = (1 << 23) * rng.choice([-1, 1], (len(c_d[2::16]), 32))
            e_d = rng.integers(-lim, lim, (B, n), dtype=np.int64)
            cd_d = torch.from_numpy(c_d).to(dev)
            ed_d = torch.from_numpy(e_d.astype(np.int32)).to(dev)
            got_d = k_iir.iir_synthesize(ed_d, cd_d)
            want_d = filters.iir_synthesize_reference(ed_d, cd_d)
            torch.cuda.synchronize()
            errs_d.append(max_abs_err(got_d, want_d))
            same = bool(torch.equal(got_d, want_d))
            exact_d = exact_d and same
            log(f"(d) [{B}, {n}] residues within +-{lim}: exact={same} "
                f"max_abs_err={errs_d[-1]}")
    check(exact_d, "IIR kernel disagrees on an edge input")
    return dict(max_abs_err=max(err, err_b, *errs_d),
                exact=exact and exact_b and exact_d, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, rows_ms=sweep)


def phase_fir_ksel(torch, ops_coeffs, filters, ops_rice, rows, rng):
    log("== phase 5: K5 (fir_rice) and K6 (ksel) against their plain versions")
    dev = torch.device("cuda")
    x, _, q, order = (a.copy() for a in rows)
    order = order.astype(np.int32)
    # guard rows: full-scale int32 noise under q = 63 at order 32 (trips);
    # c = 0 with e = x on the guard's edges: -2^30 trips, 2^30 - 1 passes
    x[0:4] = rng.integers(-(1 << 31), 1 << 31, (4, FRAME), dtype=np.int64)
    q[0:4], order[0:4] = 63, 32
    c = ops_coeffs.lpc_from_q_reference(torch.from_numpy(q),
                                        torch.from_numpy(order)).numpy()
    c[4:6], order[4:6] = 0, 7
    x[4], x[5] = -(1 << 30), (1 << 30) - 1
    nv = np.full(ROWS_MAIN, FRAME, np.int32)
    for j, tail in enumerate((2000, 1, 0)):       # tails every 64 rows
        nv[(np.arange(ROWS_MAIN) % 64) == 9 + j] = tail
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (x, c, order, nv)]
    got = filters.fir_rice(*args)
    want = filters.fir_rice_reference(*args)
    torch.cuda.synchronize()
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    exact = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
    eff = got[1].cpu().numpy()
    guard = (eff[0], eff[4], eff[5]) == (0, 0, 7)
    ms = time_kernel(torch, lambda: filters.fir_rice(*args), 50)
    plain = time_plain(torch, lambda: filters.fir_rice_reference(*args), 3)
    bms, by = fir_rice_bound(c, nv, want[0].cpu().numpy())
    log(f"K5 [{ROWS_MAIN}, {FRAME}]: exact={exact} max_abs_err={err} "
        f"guard rows as expected={guard} (fallbacks: "
        f"{int(((eff == 0) & (order > 0)).sum())}) kernel {ms:.4f} ms, "
        f"plain {plain:.2f} ms, bound {bms:.5f} ms ({by})")
    check(exact and guard, "K5 disagrees with its plain version")
    k5 = dict(max_abs_err=err, exact=exact, ms=ms, plain_ms=plain,
              bound_ms=bms, bound_by=by)

    # K6: K5's residue counts, then random and escape-forcing counts
    B = 2 * ROWS_MAIN
    n_rand = rng.integers(0, 65536, ROWS_MAIN // 2).astype(np.int32)
    frac = rng.random((ROWS_MAIN // 2, 32)) ** rng.uniform(0.2, 6, (ROWS_MAIN // 2, 1))
    c_rand = np.floor(frac * n_rand[:, None]).astype(np.int32)
    n_esc = rng.integers(1, 65536, ROWS_MAIN // 2).astype(np.int32)
    c_esc = np.repeat(n_esc[:, None], 32, axis=1)  # every bit of every code
    counts = torch.cat([got[2], torch.from_numpy(np.concatenate([c_rand, c_esc]))
                        .to(dev)]).contiguous()
    n = torch.cat([args[3], torch.from_numpy(np.concatenate([n_rand, n_esc]))
                   .to(dev)]).contiguous()
    errs, exact6 = [], True
    for k_max in (30, 7, 0):
        kg, bg = ops_rice.ksel(counts, n, k_max)
        kw, bw = ops_rice.k_and_bits_reference(counts, n, k_max)
        torch.cuda.synchronize()
        errs.append(max(max_abs_err(kg, kw), max_abs_err(bg, bw)))
        exact6 = exact6 and bool(torch.equal(kg, kw) and torch.equal(bg, bw))
        escapes = int((kg == 31).sum())
        log(f"K6 [{B}] k_max={k_max}: exact={exact6} escapes {escapes}")
    ms6 = time_kernel(torch, lambda: ops_rice.ksel(counts, n, 30), 200)
    plain6 = time_plain(torch,
                        lambda: ops_rice.k_and_bits_reference(counts, n, 30), 5)
    bms6, by6 = ksel_bound(B)
    log(f"K6 [{B}]: max_abs_err={max(errs)} kernel {ms6:.5f} ms, plain "
        f"{plain6:.3f} ms, bound {bms6:.6f} ms ({by6})")
    check(exact6, "K6 disagrees with its plain version")
    k6 = dict(max_abs_err=max(errs), exact=exact6, ms=ms6, plain_ms=plain6,
              bound_ms=bms6, bound_by=by6)
    render = dict(e=got[0], eff_order=got[1], counts=got[2], nv=nv,
                  q=torch.from_numpy(q).to(dev))
    return k5, k6, render


def phase_quarter_counts(torch, ops_rice, render, rng):
    log("== phase 5b: K8 (quarter_counts) and K6 at its v2 shape against "
        "their plain versions")
    dev = torch.device("cuda")
    # (a) K5's residues; n_valid below K5's on some rows leaves residues
    # past it, which K8 must ignore
    nv = render["nv"].copy()
    for j, v in enumerate((2048, 2000, 7, 5, 4, 3, 1, 0)):
        nv[(np.arange(ROWS_MAIN) % 64) == 20 + j] = v
    e_a = render["e"]
    nv_a = torch.from_numpy(nv).to(dev)
    # (b) uniform int32 residues with INT32_MIN rows and both extremes
    e_b = rng.integers(-(1 << 31), 1 << 31, (ROWS_MAIN, FRAME),
                       dtype=np.int64).astype(np.int32)
    e_b[::37] = -(1 << 31)
    e_b[1::37, :2] = (-(1 << 31), (1 << 31) - 1)
    e_b = torch.from_numpy(e_b).to(dev)
    # (c) the edges: 1,027 rows (not a multiple of anything the kernel
    # tiles by), n_valid on the quarters' and the lanes' edges, rows whose
    # widest zigzag code has 1, 31 and 32 bits
    B = 1027
    nv_c = torch.from_numpy(np.resize(np.array(
        [1, 3, 4, 5, 127, 128, 129, FRAME - 1, FRAME, 0], np.int32), B)).to(dev)
    wide = rng.integers(-(1 << 31), 1 << 31, (B, FRAME), dtype=np.int64)
    edges = {   # rows, and the residue whose zigzag code is the widest
        "c, widest code 1 bit": (rng.integers(-1, 1, (B, FRAME)), -1),
        "c, widest code 31 bits": (np.clip(wide, -(1 << 30), (1 << 30) - 1),
                                   -(1 << 30)),
        "c, widest code 32 bits": (wide, -(1 << 31)),
    }
    for rows, widest in edges.values():
        rows[::3, 5] = widest               # on every third row
    errs, exact = [], True
    cases = [("a", e_a, nv_a), ("b", e_b, nv_a)] + [
        (name, torch.from_numpy(rows.astype(np.int32)).to(dev), nv_c)
        for name, (rows, _) in edges.items()]
    for name, e, nv_e in cases:
        got = ops_rice.quarter_counts(e, nv_e)
        want = ops_rice.quarter_counts_reference(e, nv_e)
        torch.cuda.synchronize()
        errs.append(max_abs_err(got, want))
        same = bool(torch.equal(got, want))
        exact = exact and same
        log(f"K8 ({name}) {list(e.shape)}: exact={same} "
            f"max_abs_err={errs[-1]}")
        if name == "a":
            pc4 = got
    # timed and bounded on the main path's n_valid (phase 5's); (a)'s
    # shortened rows are for the exactness check only
    nv_main = torch.from_numpy(render["nv"]).to(dev)
    ms = time_kernel(torch, lambda: ops_rice.quarter_counts(e_a, nv_main), 200)
    # cold: 7 copies of e (8.4 MB each) exceed the L2 between two uses
    copies = [e_a.clone() for _ in range(7)]
    cold = time_kernel_cold(
        torch, lambda e: ops_rice.quarter_counts(e, nv_main), copies, 200)
    del copies
    plain = time_plain(
        torch, lambda: ops_rice.quarter_counts_reference(e_a, nv_main), 3)
    bms, by = quarter_counts_bound(e_a.cpu().numpy(), render["nv"])
    rows_ms = {}   # time against rows: 1 row is the launch and one row's chain
    for b in (1, 132, ROWS_MAIN):
        e_r, nv_r = e_a[:b].contiguous(), nv_main[:b].contiguous()
        rows_ms[b] = time_kernel(
            torch, lambda: ops_rice.quarter_counts(e_r, nv_r), 200)
    log(f"K8 [{ROWS_MAIN}, {FRAME}] at phase 5's n_valid: kernel {ms:.5f} ms "
        f"(warm L2), {cold:.5f} ms (cold, 7 copies), plain {plain:.3f} ms, "
        f"bound {bms:.5f} ms ({by}): share {share(bms, ms):.3f} warm, "
        f"{share(bms, cold):.3f} cold; rows "
        + ", ".join(f"{b}: {t:.5f} ms" for b, t in rows_ms.items()))
    check(exact, "K8 disagrees with its plain version")
    k8 = dict(max_abs_err=max(errs), exact=exact, ms=ms, cold_ms=cold,
              plain_ms=plain, bound_ms=bms, bound_by=by,
              cold_share=share(bms, cold), rows_ms=rows_ms)

    # K6 as the v2 render calls it: residue, coefficient and quarter rows
    cols = torch.arange(32, device=dev)[None, :]
    q_eff = torch.where(cols < render["eff_order"][:, None], render["q"], 0)
    counts = torch.cat([render["counts"],
                        ops_rice.bit_counts(ops_rice.zigzag(q_eff)),
                        pc4.view(4 * ROWS_MAIN, 32)]).contiguous()
    n = torch.cat([torch.from_numpy(render["nv"]).to(dev),
                   render["eff_order"],
                   ops_rice.quarter_bounds(nv_a).diff(dim=1).reshape(-1)
                   ]).contiguous()
    B = counts.shape[0]
    kg, bg = ops_rice.ksel(counts, n, 30)
    kw, bw = ops_rice.k_and_bits_reference(counts, n, 30)
    torch.cuda.synchronize()
    err6 = max(max_abs_err(kg, kw), max_abs_err(bg, bw))
    exact6 = bool(torch.equal(kg, kw) and torch.equal(bg, bw))
    ms6 = time_kernel(torch, lambda: ops_rice.ksel(counts, n, 30), 200)
    plain6 = time_plain(
        torch, lambda: ops_rice.k_and_bits_reference(counts, n, 30), 5)
    bms6, by6 = ksel_bound(B)
    log(f"K6 [{B}] (v2 shape): exact={exact6} max_abs_err={err6} kernel "
        f"{ms6:.5f} ms, plain {plain6:.3f} ms, bound {bms6:.6f} ms ({by6})")
    check(exact6, "K6 disagrees with its plain version at its v2 shape")
    k6v2 = dict(rows=B, max_abs_err=err6, exact=exact6, ms=ms6,
                plain_ms=plain6, bound_ms=bms6, bound_by=by6)
    return k8, k6v2


def phase_analysis(torch, ops_analysis, pipeline, chans):
    log("== phase 6: K3 (autocorr) and K4 (levinson) against their plain "
        "versions")
    import torch.nn.functional as tf

    dev = torch.device("cuda")
    F = CAND_MAIN // 4                 # one 512-frame stereo chunk
    pcm = np.stack([c[: F * FRAME].reshape(F, FRAME) for c in chans], axis=1)
    x = pipeline.make_candidates(torch.from_numpy(pcm).to(dev))
    x = x.reshape(CAND_MAIN, FRAME).contiguous()
    nv = torch.full((CAND_MAIN,), FRAME, dtype=torch.int32, device=dev)
    r = ops_analysis.autocorr(x)
    r_plain = ops_analysis.autocorr_reference(x)
    torch.cuda.synchronize()

    def rel_err(a, want=r_plain):
        """max |a - want| / want[0] over rows (any difference on a row whose
        r[0] is 0 counts as huge)"""
        d = (a.double() - want.double()).abs().max(dim=1).values
        r0 = want[:, 0].double()
        return float(torch.where(r0 > 0, d / r0.clamp(min=1e-300),
                                 d * 1e300).max())

    rel3 = rel_err(r)
    err3 = float((r - r_plain).abs().max())
    # the edges: 1,027 rows at lengths on the tilings' edges (a lane's 16
    # samples, a pass's 512, the 128-bit groups: N % 4 != 0 takes the scalar
    # path), with all-zero rows, INT32_MIN rows and rows of +-(2^24 - 1)
    rng = np.random.default_rng(6)
    rel_edges = []
    for n in (1, 31, 32, 33, 255, 256, 257, FRAME - 1):
        xe = rng.integers(-(1 << 23), 1 << 23, (1027, n)).astype(np.int32)
        xe[0::7] = 0
        xe[1::7] = -(1 << 31)
        xe[2::7] = (1 << 24) - 1
        xe[3::7, ::2], xe[3::7, 1::2] = (1 << 24) - 1, -((1 << 24) - 1)
        xe = torch.from_numpy(xe).to(dev)
        rel_e = rel_err(ops_analysis.autocorr(xe),
                        ops_analysis.autocorr_reference(xe))
        rel_edges.append(rel_e)
        log(f"K3 edge [1027, {n}] (zero, INT32_MIN and +-(2^24 - 1) rows): "
            f"max |dr|/r0 {rel_e:.3g}")
    ms3 = time_kernel(torch, lambda: ops_analysis.autocorr(x), 50)
    # cold: 4 copies of x (16.8 MB each) exceed the L2 between two uses
    copies = [x.clone() for _ in range(4)]
    cold3 = time_kernel_cold(torch, ops_analysis.autocorr, copies, 50)
    del copies
    rows3 = {}   # time against rows: 1 row is the launch and one row's chain
    for b in (1, 132, CAND_MAIN):
        x_r = x[:b].contiguous()
        rows3[b] = time_kernel(torch, lambda: ops_analysis.autocorr(x_r), 50)
    plain3 = time_plain(torch, lambda: ops_analysis.autocorr_reference(x), 5)
    xf = x.float() * (1.0 / 32768.0)

    def conv():   # the library yardstick: one grouped convolution
        return tf.conv1d(xf[None], xf[:, None], padding=32,
                         groups=CAND_MAIN)[0, :, 32:65]

    # the yardstick is timed, not trusted: cuDNN picks its own algorithm,
    # and its error is printed beside K3's tolerance, not held to it
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        rel_lib = rel_err(conv())
        lib3 = time_kernel(torch, conv, 10)
    bms3, by3 = autocorr_bound(CAND_MAIN, FRAME)
    log(f"K3 [{CAND_MAIN}, {FRAME}]: max |dr|/r0 {rel3:.3g} (tolerance 1e-5; "
        f"edges {max(rel_edges):.3g}), max |dr| {err3:.3g}; kernel "
        f"{ms3:.5f} ms (warm L2), {cold3:.5f} ms (cold, 4 copies), plain "
        f"{plain3:.3f} ms, conv1d {lib3:.4f} ms (max |dr|/r0 {rel_lib:.3g}"
        f"{'' if rel_lib <= 1e-5 else ', outside 1e-5'}), bound "
        f"{bms3:.5f} ms ({by3}): share {share(bms3, ms3):.3f} warm, "
        f"{share(bms3, cold3):.3f} cold; rows "
        + ", ".join(f"{b}: {t:.5f} ms" for b, t in rows3.items()))
    check(rel3 <= 1e-5 and max(rel_edges) <= 1e-5,
          "K3 is outside its tolerance")
    k3 = dict(max_abs_err=err3, max_rel_err_r0=max(rel3, *rel_edges),
              tolerance="1e-5 r0", ms=ms3, cold_ms=cold3, plain_ms=plain3,
              bound_ms=bms3, bound_by=by3, cold_share=share(bms3, cold3),
              rows_ms=rows3, library_ms=lib3, library_max_rel_err_r0=rel_lib)

    got = ops_analysis.analyze_from_r(r, nv, 32)      # the same r for both
    want = ops_analysis.analyze_from_r_reference(r, nv, 32)
    torch.cuda.synchronize()
    differ = int(((got[0] != want[0]) | (got[1] != want[1]).any(dim=1)).sum())
    err4 = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    dcost = float((got[2] - want[2]).abs().max())
    ms4 = time_kernel(torch, lambda: ops_analysis.analyze_from_r(r, nv, 32), 50)
    plain4 = time_plain(
        torch, lambda: ops_analysis.analyze_from_r_reference(r, nv, 32), 3)
    bms4, by4 = levinson_bound(CAND_MAIN)
    hist = np.bincount(got[0].cpu().numpy(), minlength=33).tolist()
    log(f"K4 [{CAND_MAIN}]: rows whose order or q differ {differ} of "
        f"{CAND_MAIN}; max_abs_err {err4}; max |dcost| {dcost:.3g} bits; "
        f"kernel {ms4:.4f} ms, plain {plain4:.2f} ms, bound {bms4:.6f} ms "
        f"({by4}); orders {hist}")
    check(differ == 0, "K4 disagrees with its plain version given the same r")
    k4 = dict(max_abs_err=err4, rows_differ=differ, max_cost_diff=dcost,
              ms=ms4, plain_ms=plain4, bound_ms=bms4, bound_by=by4)
    return k3, k4


def device_profile(torch, fn) -> tuple[float, dict]:
    """One run of fn under torch.profiler (CUPTI): the device's busy ms, and
    busy ms by kernel or copy name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            by_name[ev.key] = ev.self_device_time_total / 1e3
    return sum(by_name.values()), by_name


def phase_e2e(torch, decoder, ref_codec, WavData, Metrics, bitio, container,
              k_lpc, k_iir, name, chans, rate, bits, warm=False) -> dict:
    from sela_tpu_torch.format import FRAME_SIZE, SF_MID, SYNC

    w = WavData(rate, bits, chans)
    t0 = time.perf_counter()
    buf = ref_codec.encode_wav(w)
    enc_s = time.perf_counter() - t0
    if warm:   # first use of pinned buffers and the allocator, not counted
        decoder.decode_sela(buf, device="cuda")
    m = Metrics()
    k_lpc.launches = 0
    k_iir.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = decoder.decode_sela(buf, device="cuda", metrics=m)
    wall = time.perf_counter() - t0
    launches = {"lpc": k_lpc.launches, "iir": k_iir.launches}
    identical = all(np.array_equal(a, b) for a, b in zip(out.channels, chans))
    h = container.parse_header(buf)
    sf, _ = bitio.scan_frames(buf, container.HEADER_SIZE, h.num_frames,
                              h.channels, SYNC, FRAME_SIZE)
    pcm_mb = w.n_samples * w.n_channels * bits / 8 / 1e6
    ms_share = float(np.mean(sf["sftype"] == SF_MID)) * 2 if h.channels == 2 else 0.0
    hist = np.bincount(sf["order"], minlength=33).tolist()
    stages = {k: round(v, 4) for k, v in m.stage_s.items()}
    log(f"{name}: {w.n_samples} samples x {w.n_channels} ch, {bits}-bit "
        f"{rate} Hz, {h.num_frames} frames; oracle encode {enc_s:.1f} s, "
        f"ratio {len(buf) / (pcm_mb * 1e6):.4f}")
    log(f"  decode on the card {wall:.3f} s = {pcm_mb / wall:.1f} PCM MB/s; "
        f"stages {stages}; launches {launches}; identical={identical}")
    log(f"  mid/side frame share {ms_share:.3f}; order histogram {hist}")
    check(identical, f"{name}: decoded PCM differs from the input")
    check(launches["lpc"] > 0 and launches["iir"] > 0,
          f"{name}: a kernel was not launched on the decode path {launches}")
    if warm:   # a second, profiled run: where the device time goes
        log_profile(torch, lambda: decoder.decode_sela(buf, device="cuda"), wall)
    return dict(name=name, launches=launches, wall_s=wall,
                pcm_mb_per_s=pcm_mb / wall, stages=stages, ms_share=ms_share,
                oracle_bytes=len(buf))


def log_profile(torch, fn, wall: float) -> None:
    """A profiled run of fn: device busy ms, idle share of `wall`, top
    kernels and copies."""
    busy, by_name = device_profile(torch, fn)
    if busy > 0:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        log(f"  profiled run: device busy {busy:.3f} ms = idle share "
            f"{1 - busy / (wall * 1e3):.4f} of the timed run's wall; top: "
            + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))
        # the port's kernels (csrc/*.cu, each in an anonymous namespace),
        # whether or not they made the top ten
        ours = sorted((k.split("::")[1].split("(")[0], v)
                      for k, v in by_name.items()
                      if k.startswith("(anonymous namespace)::"))
        log("  the port's kernels: "
            + "; ".join(f"{k} {v:.4f} ms" for k, v in ours))
    else:
        log("  profiled run: the profiler saw no device time "
            "(device busy time not measured)")


ENCODE_KERNELS = ("lpc", "autocorr", "levinson", "fir_rice", "ksel")


def phase_encode(torch, encoder, decoder, ref_codec, WavData, Metrics, bitio,
                 container, k_lpc, k_iir, k_enc, name, chans, rate, bits,
                 oracle_bytes=None, max_vs_oracle=None, oracle_decode=False,
                 profile=None, warm=False) -> dict:
    """Encode on the card (the profile's path), decode on the card, check
    the launches; against the oracle's stream size where max_vs_oracle is
    given, through the oracle's decoder where oracle_decode is set; warm:
    an uncounted encode first and a profiled one after."""
    from sela_tpu_torch.format import (FRAME_SIZE, RICE_PARTITION_MARKER,
                                       SF_MID, SYNC)

    v2 = profile is not None and profile.residue_partition > 1
    w = WavData(rate, bits, chans)
    if warm:   # first use of pinned buffers and the allocator, not counted
        encoder.encode_wav(w, device="cuda", profile=profile)
    m = Metrics()
    k_lpc.launches = k_iir.launches = 0
    for kernel in k_enc.launches:
        k_enc.launches[kernel] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf = encoder.encode_wav(w, device="cuda", metrics=m, profile=profile)
    wall = time.perf_counter() - t0
    launches = {"lpc": k_lpc.launches, **k_enc.launches, "iir": k_iir.launches}
    pcm_mb = w.n_samples * w.n_channels * bits / 8 / 1e6
    h = container.parse_header(buf)
    sf, _ = bitio.scan_frames(buf, container.HEADER_SIZE, h.num_frames,
                              h.channels, SYNC, FRAME_SIZE)
    ms_share = float(np.mean(sf["sftype"] == SF_MID)) * 2 if h.channels == 2 else 0.0
    part_share = float(np.mean(sf["k_res"] == RICE_PARTITION_MARKER))
    hist = np.bincount(sf["order"], minlength=33).tolist()
    stages = {k: round(v, 4) for k, v in m.stage_s.items()}
    label = f"{name} ({'v2' if v2 else 'v1'})"
    log(f"{label}: encode on the card {wall:.3f} s = {pcm_mb / wall:.1f} PCM "
        f"MB/s; stages {stages}; launches {launches}")
    vs = ("" if oracle_bytes is None else
          f" against the oracle's {oracle_bytes / (pcm_mb * 1e6):.4f} "
          f"({len(buf)} and {oracle_bytes} bytes)")
    log(f"  ratio {len(buf) / (pcm_mb * 1e6):.4f}{vs}; {len(buf)} bytes; "
        f"partitioned subframe share {part_share:.4f}; mid/side frame share "
        f"{ms_share:.3f}; order histogram {hist}")
    needed = ENCODE_KERNELS + (("quarter_counts",) if v2 else ())
    check(all(launches[k] > 0 for k in needed),
          f"{label}: a kernel was not launched on the encode path {launches}")
    # one render a chunk: K1, K5 and one K6 launch each, K8 one under v2
    per_chunk = launches["fir_rice"]
    check(launches["lpc"] == launches["ksel"] == per_chunk
          and launches["quarter_counts"] == (per_chunk if v2 else 0),
          f"{label}: not one launch a chunk of K1, K6 (and K8) {launches}")
    check(v2 or part_share == 0.0, f"{label}: a v1 stream holds partitions")
    t0 = time.perf_counter()
    out = decoder.decode_sela(buf, device="cuda")
    identical = all(np.array_equal(a, b) for a, b in zip(out.channels, chans))
    log(f"  the port's decoder on the card gives the input back: {identical} "
        f"({time.perf_counter() - t0:.3f} s)")
    check(identical, f"{label}: the port's stream does not decode to the input")
    if oracle_decode:   # held to the spec by the oracle, not the port's decoder
        t0 = time.perf_counter()
        out = ref_codec.decode_sela(buf)
        same = all(np.array_equal(a, b) for a, b in zip(out.channels, chans))
        log(f"  the oracle decodes it to the input: {same} "
            f"({time.perf_counter() - t0:.1f} s on the CPU)")
        check(same, f"{label}: the oracle does not decode the port's stream")
    if max_vs_oracle is not None:
        check(len(buf) <= max_vs_oracle * oracle_bytes,
              f"{label}: the port's stream is over {max_vs_oracle}x the "
              f"oracle's")
    if warm:
        log_profile(torch, lambda: encoder.encode_wav(w, device="cuda",
                                                      profile=profile), wall)
    return dict(name=name, launches=launches, wall_s=wall,
                pcm_mb_per_s=pcm_mb / wall, stages=stages,
                ratio=len(buf) / (pcm_mb * 1e6), bytes=len(buf),
                partitioned_share=part_share)


def main() -> int:
    import torch

    kind, smi = phase_device(torch)
    sys.path.insert(0, HERE)
    import sela_tpu_torch

    pkg = os.path.dirname(os.path.abspath(sela_tpu_torch.__file__))
    check(pkg == os.path.join(HERE, "sela_tpu_torch"),
          f"sela_tpu_torch imported from {pkg}, not from this checkout")
    from sela_tpu_torch.codec import decoder, encoder, pipeline
    from sela_tpu_torch.config import BitstreamProfile
    from sela_tpu_torch.kernels import coeffs as k_lpc
    from sela_tpu_torch.kernels import encode as k_enc
    from sela_tpu_torch.kernels import iir as k_iir
    from sela_tpu_torch.native import bitio
    from sela_tpu_torch.ops import analysis as ops_analysis
    from sela_tpu_torch.ops import coeffs as ops_coeffs
    from sela_tpu_torch.ops import filters
    from sela_tpu_torch.ops import rice as ops_rice
    from sela_tpu_torch.ref import codec as ref_codec
    from sela_tpu_torch.ref import container
    from sela_tpu_torch.ref import lpc as ref_lpc
    from sela_tpu_torch.ref.wav import WavData
    from sela_tpu_torch.utils.build import BUILD_DIR, build_log, nvcc
    from sela_tpu_torch.utils.metrics import Metrics

    phase_build(k_lpc, k_iir, k_enc, bitio, build_log, BUILD_DIR, nvcc)
    lpc = phase_lpc(torch, ops_coeffs)

    t0 = time.perf_counter()
    cd = make_track(180.0, 44100, 16, seed=0)
    log(f"(3-minute track made in {time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(2)
    rows = oracle_rows(ref_lpc, cd, ROWS_MAIN, rng)
    iir = phase_iir(torch, ops_coeffs, filters, k_iir, rows, rng)
    k5, k6, render = phase_fir_ksel(torch, ops_coeffs, filters, ops_rice,
                                    rows, rng)
    k8, k6v2 = phase_quarter_counts(torch, ops_rice, render, rng)
    k3, k4 = phase_analysis(torch, ops_analysis, pipeline, cd)

    clips = [("cd_180s", cd, 44100, 16),
             ("hires_30s", make_track(30.0, 96000, 24, seed=1), 96000, 24)]
    c32 = make_track(10.0, 48000, 32, seed=2)
    c32[0][1000], c32[0][5000], c32[1][77_777] = -(1 << 31), (1 << 31) - 1, -(1 << 31)
    clips.append(("int32_10s", c32, 48000, 32))

    log("== phase 7: decode end to end")
    e2e_args = (torch, decoder, ref_codec, WavData, Metrics, bitio, container,
                k_lpc, k_iir)
    decoded = {name: phase_e2e(*e2e_args, name, chans, rate, bits,
                               warm=name == "cd_180s")
               for name, chans, rate, bits in clips}

    log("== phase 8: encode end to end")
    enc_args = (torch, encoder, decoder, ref_codec, WavData, Metrics, bitio,
                container, k_lpc, k_iir, k_enc)
    encoded = {name: phase_encode(
        *enc_args, name, chans, rate, bits, decoded[name]["oracle_bytes"],
        max_vs_oracle=1.01 if name == "cd_180s" else None,
        oracle_decode=bits == 32, warm=name == "cd_180s")
        for name, chans, rate, bits in clips}
    dec_main, enc_main = decoded["cd_180s"], encoded["cd_180s"]

    log("== phase 9: encode end to end, partitioned residues (v2)")
    v2 = BitstreamProfile(residue_partition=4)
    enc_v2 = phase_encode(*enc_args, "cd_180s", cd, 44100, 16, profile=v2,
                          warm=True)
    check(enc_v2["bytes"] <= enc_main["bytes"],
          "cd_180s: the v2 stream is larger than the v1 stream")
    log(f"cd_180s: v2/v1 size {enc_v2['bytes'] / enc_main['bytes']:.5f}")
    perc = make_percussive(20.0, seed=3)
    t0 = time.perf_counter()
    oracle_v2 = len(ref_codec.encode_wav(WavData(44100, 16, perc), profile=v2))
    log(f"perc_20s: oracle v2 encode {time.perf_counter() - t0:.1f} s")
    perc_v1 = phase_encode(*enc_args, "perc_20s", perc, 44100, 16)
    perc_v2 = phase_encode(*enc_args, "perc_20s", perc, 44100, 16, oracle_v2,
                           max_vs_oracle=1.01, oracle_decode=True, profile=v2,
                           warm=True)
    log(f"perc_20s: v2/v1 size {perc_v2['bytes'] / perc_v1['bytes']:.5f}, "
        f"v2/oracle v2 {perc_v2['bytes'] / oracle_v2:.5f}")
    check(perc_v2["bytes"] < 0.99 * perc_v1["bytes"],
          "perc_20s: the v2 stream is not 1% smaller than the v1 stream")

    def entry(name, source, replaces, res, launches, library_ms=None, **extra):
        return dict(name=name, route="cuda", source=f"sela_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches, **res,
                    share=share(res["bound_ms"], res["ms"]),
                    library_ms=library_ms, **extra)

    kernels = [
        entry("lpc_from_q", "lpc.cu", "sela_tpu/kernels/coeffs.py:60", lpc,
              dec_main["launches"]["lpc"],
              launches_by_path={"decode": dec_main["launches"]["lpc"],
                                "encode": enc_main["launches"]["lpc"],
                                "encode_v2": enc_v2["launches"]["lpc"]}),
        entry("iir_synthesize", "iir.cu",
              "sela_tpu/kernels/iir.py:135 (K2), sela_tpu/kernels/iir.py:40 (K7)",
              iir, dec_main["launches"]["iir"]),
        entry("autocorr", "autocorr.cu", "sela_tpu/kernels/encode.py:213",
              {k: v for k, v in k3.items() if k != "library_ms"},
              enc_main["launches"]["autocorr"], library_ms=k3["library_ms"],
              library_call="torch.nn.functional.conv1d (grouped, TF32 off)"),
        entry("levinson", "levinson.cu", "sela_tpu/kernels/encode.py:265", k4,
              enc_main["launches"]["levinson"]),
        entry("fir_rice", "fir_rice.cu", "sela_tpu/kernels/encode.py:45", k5,
              enc_main["launches"]["fir_rice"]),
        entry("ksel", "ksel.cu", "sela_tpu/kernels/encode.py:474", k6,
              enc_main["launches"]["ksel"],
              launches_by_path={"v1": enc_main["launches"]["ksel"],
                                "v2": enc_v2["launches"]["ksel"]},
              v2_shape=k6v2),
        entry("quarter_counts", "quarter_counts.cu",
              "sela_tpu/kernels/encode.py:401", k8,
              enc_v2["launches"]["quarter_counts"]),
    ]
    log("share of the bound (bound ms / kernel ms, warm L2): " + ", ".join(
        f"{k['name']} {k['share']:.3f}" for k in kernels)
        + "; cold: " + ", ".join(f"{k['name']} {k['cold_share']:.3f}"
                                 for k in kernels if "cold_share" in k))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
