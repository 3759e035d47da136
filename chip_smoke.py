#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`sela_tpu_torch`) on one CUDA card and check it.

    python3 chip_smoke.py                    # every phase, as below
    python3 chip_smoke.py --encode-profile   # phases 1-2, then the profiled
                                             # encodes alone (cd_180s v1, v2,
                                             # perc_20s v2), no result line

Phases, in order; any failure exits non-zero and prints no result line:

1. device  — require CUDA, print the card's name, count, power limit and
             maximum SM clock;
2. build   — build the nine CUDA kernel libraries and the native bit I/O
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
             residue guard and rows on its edges), timed warm and cold (x
             rotated over 4 copies, each call's e kept alive), at 1, 132
             and 1,024 rows, and against its taps (every row with 0, 8, 16,
             24 or 32 taps, its sums on the FP64 pipe and, with a
             coefficient of 2^26, as IMAD.WIDE); K5 on the edges (1,027
             rows at N = 1, 31, 32, 33, 63, 64, 65, 1,000 and 2,047: orders
             on every tap tier's edge, +-2^23 coefficients, INT32_MIN/
             INT32_MAX and full-scale rows, both guard edges, n_valid 0, 1
             and N with nonzero samples past it); the Rice k selection's
             generic entry (csrc/ksel.cu) at 2,048 rows (K5's counts,
             random and escape-forcing counts; k_max 30, 7, 0); and K6's
             render entry (`rice_plan`: all of the render's Rice planning)
             on K5's counts and eff_order and the rows' q at 1,024 rows,
             timed warm and at 1, 132 and 1,024 rows; all exactly;
5b. K8, K6 — the per-quarter bit counts (csrc/quarter_counts.cu) at [1,024,
             2,048], exactly: (a) phase 5's K5 residues with n_valid 2,048,
             2,000, 7, 5, 4, 3, 1 and 0 on some rows, (b) uniform int32
             residues holding INT32_MIN and INT32_MAX, (c) the edges: 1,027
             rows with n_valid 1, 3, 4, 5, 127, 128, 129, 2,047, 2,048 and 0,
             whose widest zigzag code has 1, 31 and 32 bits; timed and
             bounded on (a)'s residues at phase 5's n_valid, warm (L2) and
             cold (input rotated over 7 copies), and at 1, 132 and 1,024
             rows; then K6's generic entry at its old v2 shape, 6,144 rows
             (K5's counts, the coefficient counts and K8's quarters of
             (a)), and its render entry under v2 (K8's quarters at phase
             5's n_valid, timed as in phase 5) and on the edges (1,027
             rows, v1 and v2, k_max 30, 7 and 0: n_valid 0, 3, 4, 5, 2,047
             and 2,048, eff_order 0, 1, 31 and 32, q of -64, 63, INT32_MIN
             and INT32_MAX, escape-forcing rows), exactly;
6. K3, K4  — autocorrelation (csrc/autocorr.cu) and Levinson / order
             selection (csrc/levinson.cu) at the main path's [2,048, 2,048]
             candidate rows of the CD track: K3 within 1e-5 of r[0] a row
             (and the conv1d yardstick with it), also on the edges (1,027
             rows at N = 1, 31, 32, 33, 255, 256, 257 and 2,047 with
             all-zero, INT32_MIN and +-(2^24 - 1) rows), timed warm and
             cold (4 copies) and at 1, 132 and 2,048 rows; K4 given K3's r
             identical in order and q on every row and its cost within rtol
             1.2e-7, timed at 1, 132 and 2,048 rows, and on the edges (1,027
             rows with r = 0, r0 = 0 and r0 < 0 rows and n_valid 0, at
             max_order 1, 8 and 32);
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
             well), K1, K3, K4, K5 and K6 must have run once a chunk, the
             Rice packer twice a chunk (v1 packs its plain blocks on the
             card) and K8 never, and the CD stream may be at most 1% larger
             than the
             oracle's; one profiled encode gives the device busy time,
             the device kernels launched and PyTorch's reduction and int64
             elementwise rows among them;
9. encode v2 — `encode_wav` with partitioned residues (residue_partition=4)
             on the card: the CD track, whose stream may be no larger than
             the v1 stream of phase 8, and a 20 s 16-bit/44.1 kHz percussive
             clip, whose v2 stream must be more than 1% smaller than its v1
             stream and at most 1% larger than the oracle's v2 stream, and
             must decode to the input through the oracle too; K8 and K6 run
             once a chunk and the packer never (v2 packs on the host); one
             profiled encode of each clip;
9b. plain planning — the `cd_180s` v1 and `perc_20s` v2 encodes again with
             `pipeline.rice_plan` set to its plain version on the card (a
             check, not a fallback): the streams must be byte-identical;
             the Rice packer must not have run in phase 7 (decode);
10. packer — the device Rice packer (csrc/pack.cu) against its plain version
             on the card and against the host packer's words, exactly: (a)
             the residues of the `cd_180s` v1 encode's first 512-frame chunk
             at their planned k (escape rows left out), whose word counts
             must be the plan's; (b) forced k = 0, 1, 5, 13 and 30 on
             values up to a few bits past the k's range; (c) the edges:
             1,027 rows with n_valid 0, 1, 31, 32, 33, 2,047 and 2,048, k =
             30 rows whose patterns straddle words, rows over max_words, and
             the word buffer in the output (max_words over 12,000); timed on
             (a) warm and cold (values rotated over 7 copies) and at 1, 132
             and all rows, beside the host packer on the same blocks;
11. the slice's paths — `bench.bench_e2e` on `cd_180s` (encode v1 and
             decode, each the minimum of 3 walls), `bench.bench_batch64` (64
             files through the corpus codec, bit-exact, K1, K3-K6 and the IIR
             launched), `decode_stream` of the `cd_180s` v1 stream (the blocks
             equal decode_sela's PCM; time to the first block and in all),
             `bench.bench_host_pack` and `bench.bench_device_pack` (the
             packer A/B, the packer launched) at the CD chunk's [1,024,
             2,048], and `bench.bench_device_pipeline` at 8 chunks of 512
             frames;
12. the parallel paths — (a) a 20-minute 16-bit/44.1 kHz stereo track
             tiled from `cd_180s` (25,840 frames, 211.68 MB of PCM); (b)
             `parallel.mesh.dryrun_multichip` over every visible card at full
             width (the unsharded integer render of the sharded v2 planning
             equals it; the round trip is bit-exact), the v2 encode step and
             the v1 codec step over 1 shard and over 4 shards of cuda:0
             (identical planning and PCM, every frame exact), and the 32-bit
             codec step of `int32_10s` over 4 shards, padded (K7): each
             step's device ms (CUDA events) and PCM GB/s, K1, the IIR,
             K3-K6 and K8 launched; (c) 1, 2 and 4 `shard_worker` processes
             on the card at once, joined over gloo on 127.0.0.1: each merge's
             sha256 equals one `encode_wav` of the track in this process, the
             4-rank merge decodes to the input; per-rank `wall_s` and process
             walls, balance, aggregate MB/s and scaling efficiency against
             the 1-rank run; (d) one of two ranks killed after joining: the
             other exits 0, `missing_shards` names the dead one, which re-run
             alone gives the same sha256;
13. the tools (`sela_tpu_torch.tools`) — (a) K9, the int32 chain kernel
             (csrc/int_chain.cu), against its plain version, exactly, at
             [8, 128] with T = 1,000, at the roofline tool's four readings
             ([512, 128] at T = 2^16 and 2^19, [8, 128] at 2^20 and 2^23)
             and at its card-filling [2,112, 128]; (b) its static SASS: one
             IMAD a step (UNROLL in the unrolled loop, one in the remainder
             loop, each with the step's addend); (c) `tools.roofline` in
             full, K9's launches counted; (d) `tools.profile_stages --only`
             for every stage, in process, at F = 1,024, and the glue of
             `encode_step`; (e) `tools.sweep_ratio --seconds 10`; (f)
             `tools.measure_scaling --ranks 2` at its default 48 s (the
             merge's sha256 is a hard gate; its efficiency exit code is a
             reading); (g) `tools.check_regression` on a bench line of this
             run: against itself it passes, with every ratio grown 20% it
             fails, against another device's name it refuses;
14. hostile streams — tests/test_torch_hostile.py's five base clips (16-bit
             mono, 16-bit stereo with mid/side, a 16-bit v2 burst/quiet
             clip, 24-bit stereo tones at LPC order 13, 32-bit mono holding
             INT32_MIN and INT32_MAX) and the wrapping stream (the mono clip
             with byte 27 ^= 5, whose samples leave int16), unmutated, and
             60 seeded mutations of each base clip (1-8 bytes XORed, every
             third in the first 40 bytes); then the structure-aware
             mutations of tests/test_torch_hostile_fields.py (the same
             functions): the base clips, mono16 and stereo24 with a SeTg and
             an APEv2 trailer and a 16-bit stereo clip of four frames, with
             a byte of each field XORed (3 seeded draws a field), each
             field edited at FORMAT.md's limits, cut at and inside each
             field, and junk, a second trailer or a word left after the
             last frame: each through `decode_sela`, `decode_stream` and
             `decode_files` on the card (one frame a chunk) and on the CPU
             (in worker processes meanwhile), and through the port's
             oracle; every path refuses (ContainerError) exactly where the
             oracle does on both devices, its PCM on the card equals its
             PCM on the CPU and the oracle's samples (`decode_sela`'s
             wrapped to int16 on <= 16-bit streams, as both packages narrow
             them), but where the oracle's reconstruction leaves int32 (its
             int64 history against the port's 32-bit wrap, K7's contract),
             K1 and the IIR ran, and on the wrapping stream `decode_stream`
             and `decode_files` give the oracle's int32 samples
             (-95,390..97,155) and `decode_sela` its int16 narrowing; on
             every stream the oracle refuses, the card's `decode_stream`
             yields the oracle's frames before the one it refuses and then
             raises ContainerError; every structure-aware stream, put
             between two valid files of its group in one `decode_files` on
             the card, is refused before any device step where the oracle
             refuses it, and otherwise each of the three files equals its
             one-file decode; prints the streams each path accepted and
             took with the int32 residue wire, the streams exempt from the
             oracle's samples, the refusals by field, and the phase's
             seconds;
15. each kernel's share of its bound, the `kernels` JSON line (with each
   kernel's launches on phase 12's sharded path and K9's on phase 13's
   roofline), then the card's name and power limit, then the last line
   `{"ok": true, "device": {...}}`.

Comparisons of the normative integer kernels are exact (max_abs_err 0); K3's
tolerance and K4's rule are stated in phase 6. Kernel times are CUDA-event
times of many back-to-back launches queued behind a device-side sleep, so
host launch overhead is not in them; "warm" times find the input in the L2
cache (back to back on one input), "cold" ones rotate over copies that
together exceed it. A kernel's share is its bound over its time.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Peaks of one H100 SXM: 3.35 TB/s of HBM and 67 TFLOP/s of float32 outside
# the tensor cores with an FMA counted as two (NVIDIA's data sheet). Integer
# work is counted in int32 lane-instructions at 64 a clock a SM (132 SMs,
# the maximum SM clock of 1,980 MHz): the K9 chain kernel (tools/roofline)
# measured 61.2 independent 32-bit IMADs a clock a SM on a card-filling
# shape, on an H100 80GB HBM3 at 700 W, not the float32 FMA lanes' 128. A
# 32x32->64 multiply-add into a 64-bit sum counts 4 (the wide product 2,
# the carried 64-bit add 2).
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 64 * 132 * 1.98e9
FLOPS_PER_S = 67e12                 # float32, an FMA counted as two
MAC64_OPS = 4
LEVINSON_STEP_OPS = MAC64_OPS + 6   # + round, shift, subtract, clamp (64-bit)
IIR_SAMPLE_OPS = 4                  # round, shift, low-32 add of e per sample
FIR_SAMPLE_OPS = 10                 # round, shift, subtract (64-bit), guard,
                                    # select, zigzag per valid sample
BITCOUNT_OPS = 3                    # shift, mask and add of one word of 8
                                    # packed nibble counters, per sample and
                                    # 8 bits of the row's widest code
QUARTER_SAMPLE_OPS = 8              # zigzag (3), quarter index (3 compares,
                                    # 2 adds) per valid sample
KSEL_STEP_OPS = 8                   # 64-bit shift-add, cost, compare, select
RICE_PLAN_ROW_OPS = 16              # block words, the v2 decision, packing
PACK_VALUE_OPS = 16                 # zigzag, code length and its 64-bit sum,
                                    # pattern, stop bit, word and shift, OR

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


def bitcount_ops(e: np.ndarray, nv: np.ndarray) -> np.ndarray:
    """Lane operations a sample for the per-bit counts of each row: one
    packed word of 8 nibble counters (a shift, a mask and an add) per 8 bits
    of the row's widest zigzag code (higher counts are zero)."""
    return BITCOUNT_OPS * -(-zigzag_widths(e, nv) // 8)


def fir_rice_bound(c: np.ndarray, nv: np.ndarray, e: np.ndarray):
    """K5 on these rows: reads x up to n_valid, c, order and n_valid, writes
    e (the whole row), eff_order and counts. Per valid sample: a 64-bit
    multiply-add per tap below the row's highest nonzero coefficient, the
    epilogue, and the packed bit counts up to the row's widest code."""
    B, N = e.shape
    nz = c != 0
    taps = np.where(nz.any(axis=1), 32 - np.argmax(nz[:, ::-1], axis=1), 0)
    valid = np.clip(nv.astype(np.int64), 0, N)
    ops = (valid * (MAC64_OPS * taps + FIR_SAMPLE_OPS
                    + bitcount_ops(e, valid))).sum()
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
    sample: the zigzag and the quarter index, and the packed bit counts up
    to the row's widest code."""
    B, N = e.shape
    valid = np.clip(nv.astype(np.int64), 0, N)
    ops = (valid * (QUARTER_SAMPLE_OPS + bitcount_ops(e, valid))).sum()
    return bound_ms(valid.sum() * 4 + B * (4 + 4 * 32 * 4), ops)


def ksel_bound(B: int) -> tuple[float, str]:
    """K6: reads counts and n, writes k and bits; 31 recurrence steps."""
    return bound_ms(B * (32 * 4 + 3 * 4), B * 31 * KSEL_STEP_OPS)


def rice_plan_bound(q_eff: np.ndarray, eff: np.ndarray,
                    partition: bool) -> tuple[float, str]:
    """K6's render entry on these rows: reads counts_res, q, eff_order and
    n_valid (and [4, 32] quarter counts a row under v2), writes q_eff and
    six [B] outputs. Per row: the zigzag of 32 coefficients and their bit
    counts up to the row's widest code (2 operations a code a bit), 31
    recurrence steps for each of its 2 (v2: 6) selections, the epilogue."""
    B = len(eff)
    sel = 6 if partition else 2
    widths = zigzag_widths(q_eff, eff).astype(np.int64)
    ops = (32 * (3 + 2 * widths) + sel * 31 * KSEL_STEP_OPS
           + RICE_PLAN_ROW_OPS).sum()
    nbytes = B * (2 * 32 * 4 + 2 * 4 + (4 * 32 * 4 if partition else 0)
                  + 32 * 4 + 6 * 4)
    return bound_ms(nbytes, ops)


def autocorr_bound(B: int, N: int) -> tuple[float, str]:
    """K3: reads x, writes r; 33 float multiply-adds a sample."""
    return bound_ms(B * (N * 4 + 33 * 4), B * N * 33 * 2, FLOPS_PER_S)


def levinson_bound(B: int) -> tuple[float, str]:
    """K4: reads r and n, writes order, q and cost; per row the 32 steps'
    dot products and updates (4(m-1) + 12 flops at step m) and 33 costs,
    a logarithm counted as 20 flops."""
    flops = sum(4 * (m - 1) + 12 for m in range(1, 33)) + 33 * (20 + 6)
    return bound_ms(B * (33 * 4 + 4 + 4 + 32 * 4 + 4), B * flops, FLOPS_PER_S)


def pack_bound(nv: np.ndarray, N: int, max_words: int) -> tuple[float, str]:
    """The Rice packer on these rows: reads the values up to n_valid, k and
    n_valid, writes max_words words and nwords a row; its per-value work."""
    B = len(nv)
    valid = np.clip(nv.astype(np.int64), 0, N).sum()
    return bound_ms(valid * 4 + B * (4 + 4 + max_words * 4 + 8),
                    valid * PACK_VALUE_OPS)


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


def phase_build(k_lpc, k_iir, k_enc, k_pack, k_chain, bitio, build_log,
                build_dir, nvcc) -> None:
    log("== phase 2: build")

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    jobs = {"sela_lpc": k_lpc.load, "sela_iir": k_iir.load,
            "sela_pack": k_pack.load, "sela_int_chain": k_chain.load,
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


FIR_EDGE_N = (1, 31, 32, 33, 63, 64, 65, 1000, FRAME - 1)
FIR_EDGE_ORDERS = (0, 1, 8, 9, 16, 17, 24, 25, 32)   # K5's tap tiers' edges


def fir_edge_rows(torch, ops_coeffs, rng, B: int, n: int):
    """K5's edge rows, [B, n] (numpy x, c, order, n_valid): orders on every
    tap tier's edges; every 11th row +-2^23 on each tap up to its order;
    16-bit, 8-bit and full-scale int32 noise, smooth int32 walks and rows
    alternating INT32_MIN and INT32_MAX; n_valid N, 0, 1 and between, with
    nonzero samples past it; rows 0-3 on both guard edges (c = 0, so e = x:
    -2^30 and 2^30 trip, 2^30 - 1 and -(2^30 - 1) pass)."""
    order = np.resize(np.array(FIR_EDGE_ORDERS, np.int32), B)
    q = rng.integers(-64, 64, (B, 32)).astype(np.int32)
    c = ops_coeffs.lpc_from_q_reference(torch.from_numpy(q),
                                        torch.from_numpy(order)).numpy()
    big = np.arange(B) % 11 == 3
    c[big] = (1 << 23) * rng.choice([-1, 1], (int(big.sum()), 32)) * (
        np.arange(32)[None, :] < order[big, None])
    kind = np.arange(B) % 5
    lim = np.where(kind == 0, 1 << 15, np.where(kind == 1, 1 << 8, 1 << 31))
    x = (rng.integers(-(1 << 31), 1 << 31, (B, n), dtype=np.int64)
         * lim[:, None]) >> 31
    walk = np.cumsum(rng.integers(-(1 << 16), 1 << 16, (B, n)), axis=1)
    x[kind == 3] = np.clip(walk[kind == 3] * 1024, -(1 << 31), (1 << 31) - 1)
    x[kind == 4] = np.where(np.arange(n) % 2 == 0, -(1 << 31), (1 << 31) - 1)
    x = x.astype(np.int32)
    c[:4], order[:4] = 0, 7
    x[:4] = np.array([-(1 << 30), (1 << 30) - 1, 1 << 30, -((1 << 30) - 1)],
                     np.int32)[:, None]
    nv = rng.integers(0, n + 1, B).astype(np.int32)
    nv[::4], nv[1::4], nv[2::4] = n, 0, 1
    nv[:4] = n
    return x, c, order, nv


def fir_rice_taps(torch, filters, args) -> dict:
    """K5's time against its taps: the CD rows' x under coefficients with
    exactly t taps on every row, |c| < 2^12 (the sums take the FP64 pipe),
    and the same with c_t = 2^26 (outside its domain: IMAD.WIDE); every
    residue passes the guard. Exact, and timed warm."""
    rng = np.random.default_rng(4)
    x = args[0].clone()
    x[:6] = x[6:12]                 # no full-scale guard rows
    B = x.shape[0]
    nv = torch.full_like(args[3], FRAME)
    out = {}
    for path, last in (("f64", 77), ("int", 1 << 26)):
        for t in (0, 8, 16, 24, 32):
            c = np.zeros((B, 32), np.int32)
            c[:, :t] = rng.integers(-(1 << 12), 1 << 12, (B, t))
            if t:
                c[:, t - 1] = last
            ct = torch.from_numpy(c).to(x.device)
            order = torch.full_like(args[2], t)
            got = filters.fir_rice(x, ct, order, nv)
            want = filters.fir_rice_reference(x, ct, order, nv)
            torch.cuda.synchronize()
            check(all(bool(torch.equal(g, w)) for g, w in zip(got, want))
                  and bool((got[1] == t).all()),
                  f"K5 disagrees at {t} taps ({path})")
            out[f"{path}{t}"] = time_kernel(
                torch, lambda: filters.fir_rice(x, ct, order, nv), 200)
    log("K5 [1024, 2048] time against taps (exact; ms): " + ", ".join(
        f"{k} {v:.5f}" for k, v in out.items()))
    return out


def fir_rice_edges(torch, ops_coeffs, filters) -> int:
    """K5 against its plain version on fir_edge_rows at every N of
    FIR_EDGE_N (1,027 rows: not a multiple of anything the kernel tiles
    by), exactly; returns the largest difference (0)."""
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    errs = []
    for n in FIR_EDGE_N:
        rows = fir_edge_rows(torch, ops_coeffs, rng, 1027, n)
        args = [torch.from_numpy(a).to(dev) for a in rows]
        got = filters.fir_rice(*args)
        want = filters.fir_rice_reference(*args)
        torch.cuda.synchronize()
        errs.append(max(max_abs_err(g, w) for g, w in zip(got, want)))
        same = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
        eff = want[1].cpu().numpy()
        log(f"K5 edge [1027, {n}]: exact={same} max_abs_err={errs[-1]} "
            f"(fallbacks {int(((eff == 0) & (rows[2] > 0)).sum())})")
        check(same, f"K5 disagrees with its plain version at [1027, {n}]")
    return max(errs)


def rice_plan_main(torch, ops_rice, counts, q, eff, nv, qc, label) -> dict:
    """K6's render entry at the main path's shape against its plain version
    (k_max 30, the default profile's), exactly; timed warm, at 1, 132 and
    all rows, against rice_plan_bound."""
    got = ops_rice.rice_plan(counts, q, eff, nv, 30, qc)
    want = ops_rice.rice_plan_reference(counts, q, eff, nv, 30, qc)
    torch.cuda.synchronize()
    err = max(max_abs_err(got[k], want[k]) for k in want)
    exact = all(bool(torch.equal(got[k], want[k])) for k in want)
    ms = time_kernel(torch, lambda: ops_rice.rice_plan(counts, q, eff, nv, 30,
                                                       qc), 200)
    plain = time_plain(torch, lambda: ops_rice.rice_plan_reference(
        counts, q, eff, nv, 30, qc), 5)
    B = q.shape[0]
    rows_ms = {}   # time against rows: 1 row is the launch and one row's chain
    for b in (1, 132, B):
        a_r = [t[:b].contiguous() for t in (counts, q, eff, nv)]
        qc_r = None if qc is None else qc[:b].contiguous()
        rows_ms[b] = time_kernel(
            torch, lambda: ops_rice.rice_plan(*a_r, 30, qc_r), 200)
    bms, by = rice_plan_bound(want["q_eff"].cpu().numpy(), eff.cpu().numpy(),
                              qc is not None)
    k_res = want["k_res"].cpu().numpy()
    log(f"K6 rice_plan {label} [{B}]: exact={exact} max_abs_err={err} "
        f"(escapes {int((k_res == 31).sum())}, partitioned "
        f"{int((k_res == 32).sum())}) kernel {ms:.5f} ms, plain {plain:.3f} "
        f"ms, bound {bms:.6f} ms ({by}): share {share(bms, ms):.3f}; rows "
        + ", ".join(f"{b}: {t:.5f} ms" for b, t in rows_ms.items()))
    check(exact, f"K6's render entry disagrees with its plain version ({label})")
    return dict(rows=B, max_abs_err=err, exact=exact, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, rows_ms=rows_ms)


def rice_plan_edges(torch, ops_rice) -> int:
    """K6's render entry against its plain version on 1,027 rows (not a
    multiple of a block's rows), v1 and v2 at k_max 30, 7 and 0, exactly:
    residues whose scale changes from quarter to quarter, n_valid 0, 3, 4,
    5, 2,047 and 2,048 on every other row, eff_order 0, 1, 31 and 32 on
    four rows of five, q rows of -64, 63, INT32_MIN, INT32_MAX and both
    extremes, rows of INT32_MIN residues (counts = n in every column: the
    escape). Returns the largest difference (0)."""
    rng = np.random.default_rng(8)
    dev = torch.device("cuda")
    B, N = 1027, FRAME
    nv = rng.integers(0, N + 1, B).astype(np.int32)
    nv[::2] = np.resize(np.array([0, 3, 4, 5, N - 1, N], np.int32),
                        len(nv[::2]))
    eff = rng.integers(0, 33, B).astype(np.int32)
    for i, v in enumerate((0, 1, 31, 32)):
        eff[i::5] = v
    q = rng.integers(-64, 64, (B, 32)).astype(np.int32)
    q[0::9], q[1::9], q[2::9], q[3::9] = -64, 63, -(1 << 31), (1 << 31) - 1
    q[4::9] = np.where(np.arange(32) % 2, -(1 << 31), (1 << 31) - 1)
    scale = 2.0 ** rng.uniform(0, 16, (B, 4))
    e = np.round(rng.laplace(0, 1, (B, N)) * np.repeat(scale, N // 4, axis=1))
    e = np.clip(e, -(1 << 31), (1 << 31) - 1).astype(np.int32)
    e[5::11] = -(1 << 31)
    et, nvt = torch.from_numpy(e).to(dev), torch.from_numpy(nv).to(dev)
    valid = torch.arange(N, device=dev)[None, :] < nvt[:, None]
    counts = ops_rice.bit_counts(ops_rice.zigzag(torch.where(valid, et, 0)))
    qc4 = ops_rice.quarter_counts_reference(et, nvt)
    args = (counts, torch.from_numpy(q).to(dev), torch.from_numpy(eff).to(dev),
            nvt)
    errs = []
    for qc in (None, qc4):
        for k_max in (30, 7, 0):
            got = ops_rice.rice_plan(*args, k_max, qc)
            want = ops_rice.rice_plan_reference(*args, k_max, qc)
            torch.cuda.synchronize()
            errs.append(max(max_abs_err(got[k], want[k]) for k in want))
            same = all(bool(torch.equal(got[k], want[k])) for k in want)
            k_res = want["k_res"].cpu().numpy()
            label = "v1" if qc is None else "v2"
            log(f"K6 rice_plan edges {label} [{B}] k_max={k_max}: exact={same}"
                f" (escapes {int((k_res == 31).sum())}, empty "
                f"{int((nv == 0).sum())}, partitioned "
                f"{int((k_res == 32).sum())})")
            check(same, f"K6's render entry disagrees on the edges ({label}, "
                  f"k_max {k_max})")
    return max(errs)


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
    ms = time_kernel(torch, lambda: filters.fir_rice(*args), 200)
    # cold: 4 copies of x (8.4 MB each), and each call's e kept until its
    # copy comes round again, so x and e (16.8 MB a call) exceed the L2
    # between two uses
    copies = [args[0].clone() for _ in range(4)]
    ring = [None] * len(copies)
    calls = iter(range(1 << 30))

    def cold_call(xc):
        i = next(calls) % len(ring)
        ring[i] = None
        ring[i] = filters.fir_rice(xc, *args[1:])

    cold = time_kernel_cold(torch, cold_call, copies, 200)
    del copies, ring
    plain = time_plain(torch, lambda: filters.fir_rice_reference(*args), 3)
    bms, by = fir_rice_bound(c, nv, want[0].cpu().numpy())
    rows_ms = {}   # time against rows: 1 row is the launch and one row's chain
    for b in (1, 132, ROWS_MAIN):
        args_r = [a[:b].contiguous() for a in args]
        rows_ms[b] = time_kernel(torch, lambda: filters.fir_rice(*args_r), 200)
    log(f"K5 [{ROWS_MAIN}, {FRAME}]: exact={exact} max_abs_err={err} "
        f"guard rows as expected={guard} (fallbacks: "
        f"{int(((eff == 0) & (order > 0)).sum())}) kernel {ms:.5f} ms (warm "
        f"L2), {cold:.5f} ms (cold, 4 copies), plain {plain:.2f} ms, bound "
        f"{bms:.5f} ms ({by}): share {share(bms, ms):.3f} warm, "
        f"{share(bms, cold):.3f} cold; rows "
        + ", ".join(f"{b}: {t:.5f} ms" for b, t in rows_ms.items()))
    check(exact and guard, "K5 disagrees with its plain version")
    taps_ms = fir_rice_taps(torch, filters, args)
    err_edges = fir_rice_edges(torch, ops_coeffs, filters)
    k5 = dict(max_abs_err=max(err, err_edges), exact=exact, ms=ms,
              cold_ms=cold, plain_ms=plain, bound_ms=bms, bound_by=by,
              cold_share=share(bms, cold), rows_ms=rows_ms, taps_ms=taps_ms)

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
    k6 = dict(rows=B, max_abs_err=max(errs), exact=exact6, ms=ms6,
              plain_ms=plain6, bound_ms=bms6, bound_by=by6)
    render = dict(e=got[0], eff_order=got[1], counts=got[2], nv=nv,
                  q=torch.from_numpy(q).to(dev))
    # K6's render entry as the v1 render calls it on this chunk's rows: K5's
    # counts and eff_order, the rows' q
    plan = rice_plan_main(torch, ops_rice, got[2], render["q"], got[1],
                          args[3], None, "v1")
    return k5, k6, plan, render


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

    # K6's render entry as the v2 render calls it: K8's quarters at the
    # main path's n_valid; then the edges, v1 and v2
    plan_v2 = rice_plan_main(torch, ops_rice, render["counts"], render["q"],
                             render["eff_order"], nv_main,
                             ops_rice.quarter_counts(e_a, nv_main), "v2")
    plan_v2["max_abs_err"] = max(plan_v2["max_abs_err"],
                                 rice_plan_edges(torch, ops_rice))
    return k8, k6v2, plan_v2


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
    ms4 = time_kernel(torch, lambda: ops_analysis.analyze_from_r(r, nv, 32), 200)
    plain4 = time_plain(
        torch, lambda: ops_analysis.analyze_from_r_reference(r, nv, 32), 3)
    bms4, by4 = levinson_bound(CAND_MAIN)
    rows4 = {}   # time against rows: 1 row is the launch and one row's chain
    for b in (1, 132, CAND_MAIN):
        r_r, nv_r = r[:b].contiguous(), nv[:b].contiguous()
        rows4[b] = time_kernel(
            torch, lambda: ops_analysis.analyze_from_r(r_r, nv_r, 32), 200)
    hist = np.bincount(got[0].cpu().numpy(), minlength=33).tolist()
    log(f"K4 [{CAND_MAIN}]: rows whose order or q differ {differ} of "
        f"{CAND_MAIN}; max_abs_err {err4}; max |dcost| {dcost:.3g} bits; "
        f"kernel {ms4:.5f} ms, plain {plain4:.2f} ms, bound {bms4:.6f} ms "
        f"({by4}); rows "
        + ", ".join(f"{b}: {t:.5f} ms" for b, t in rows4.items())
        + f"; orders {hist}")
    check(differ == 0, "K4 disagrees with its plain version given the same r")
    check(bool(torch.allclose(got[2], want[2], rtol=1.2e-7, atol=0.0)),
          "K4's cost is outside rtol 1.2e-7 of its plain version's")
    # the edges: 1,027 rows (not a multiple of a block's rows) of K3's r on
    # the candidates, with r = 0 rows, r0 = 0 and r0 < 0 rows under other
    # lags, n_valid 0 and between, at max_order 1, 8 and 32
    rng = np.random.default_rng(7)
    B = 1027
    r_e = r[:B].clone()
    r_e[0::13] = 0.0
    r_e[1::13, 0] = 0.0
    r_e[2::13, 0] = -r_e[2::13, 0].abs() - 1.0
    nv_e = torch.from_numpy(rng.integers(0, FRAME + 1, B).astype(np.int32)).to(dev)
    nv_e[3::13] = 0
    for max_order in (1, 8, 32):
        g = ops_analysis.analyze_from_r(r_e, nv_e, max_order)
        w = ops_analysis.analyze_from_r_reference(r_e, nv_e, max_order)
        torch.cuda.synchronize()
        d = int(((g[0] != w[0]) | (g[1] != w[1]).any(dim=1)).sum())
        close = bool(torch.allclose(g[2], w[2], rtol=1.2e-7, atol=0.0))
        err4 = max(err4, max_abs_err(g[0], w[0]), max_abs_err(g[1], w[1]))
        log(f"K4 edge [{B}] max_order {max_order}: rows whose order or q "
            f"differ {d}; cost within rtol 1.2e-7: {close}")
        check(d == 0 and close, f"K4 disagrees on the edges at max_order "
              f"{max_order}")
    k4 = dict(max_abs_err=err4, rows_differ=differ, max_cost_diff=dcost,
              ms=ms4, plain_ms=plain4, bound_ms=bms4, bound_by=by4,
              rows_ms=rows4)
    return k3, k4


def device_profile(torch, fn) -> tuple[float, dict]:
    """One run of fn under torch.profiler (CUPTI): the device's busy ms, and
    busy ms by kernel or copy name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, count = {}, {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            by_name[ev.key] = ev.self_device_time_total / 1e3
            count[ev.key] = ev.count
    return sum(by_name.values()), by_name, count


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


def launch_rows(by_name: dict, count: dict) -> str:
    """Device kernels launched in a profiled run (copies and fills apart),
    and PyTorch's glue among them: its reductions and its int64 elementwise
    kernels (launches and device ms)."""
    import re

    def rows(pick):
        keys = [k for k in by_name if pick(k)]
        return sum(count[k] for k in keys), sum(by_name[k] for k in keys)

    kern = rows(lambda k: not k.startswith(("Memcpy", "Memset")))
    torch_k = rows(lambda k: "at::native" in k)
    reduce_k = rows(lambda k: "reduce_kernel" in k)
    long_k = rows(lambda k: "elementwise_kernel" in k
                  and re.search(r"\blong\b", k) is not None)
    return (f"device kernels launched {kern[0]} ({kern[1]:.3f} ms): "
            f"PyTorch's {torch_k[0]} ({torch_k[1]:.3f} ms), of them "
            f"reduce_kernel {reduce_k[0]} ({reduce_k[1]:.3f} ms) and int64 "
            f"elementwise {long_k[0]} ({long_k[1]:.3f} ms)")


def log_profile(torch, fn, wall: float) -> None:
    """A profiled run of fn: device busy ms, idle share of `wall`, top
    kernels and copies."""
    busy, by_name, count = device_profile(torch, fn)
    if busy > 0:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        log(f"  profiled run: device busy {busy:.3f} ms = idle share "
            f"{1 - busy / (wall * 1e3):.4f} of the timed run's wall; top: "
            + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))
        log("  " + launch_rows(by_name, count))
        # the port's kernels (csrc/*.cu, each in an anonymous namespace),
        # whether or not they made the top ten
        # (a template's name starts with its return type)
        ours = sorted((k.split("(anonymous namespace)::")[1].split("(")[0], v)
                      for k, v in by_name.items()
                      if "(anonymous namespace)::" in k and "at::" not in k)
        log("  the port's kernels: "
            + "; ".join(f"{k} {v:.4f} ms" for k, v in ours))
    else:
        log("  profiled run: the profiler saw no device time "
            "(device busy time not measured)")


ENCODE_KERNELS = ("lpc", "autocorr", "levinson", "fir_rice", "ksel")


def reset_launches(k_lpc, k_iir, k_enc) -> None:
    """Every launch counter of the encode and decode kernels to 0."""
    k_lpc.launches = k_iir.launches = 0
    for kernel in k_enc.launches:
        k_enc.launches[kernel] = 0


def phase_encode(torch, encoder, decoder, ref_codec, WavData, Metrics, bitio,
                 container, k_lpc, k_iir, k_enc, k_pack, name, chans, rate,
                 bits,
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
    reset_launches(k_lpc, k_iir, k_enc)
    k_pack.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf = encoder.encode_wav(w, device="cuda", metrics=m, profile=profile)
    wall = time.perf_counter() - t0
    launches = {"lpc": k_lpc.launches, **k_enc.launches, "iir": k_iir.launches,
                "pack": k_pack.launches}
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
        f"{ms_share:.3f}; int32 residue fetches "
        f"{m.counters.get('int32_fetch', 0)} chunks; blocks packed on the "
        f"card {m.counters.get('pack_blocks_device', 0)}, on the host "
        f"{m.counters.get('pack_blocks_host', 0)}; order histogram {hist}")
    needed = ENCODE_KERNELS + (("quarter_counts",) if v2 else ())
    check(all(launches[k] > 0 for k in needed),
          f"{label}: a kernel was not launched on the encode path {launches}")
    # one render a chunk: K1, K5 and one K6 launch each, K8 one under v2
    per_chunk = launches["fir_rice"]
    check(launches["lpc"] == launches["ksel"] == per_chunk
          and launches["quarter_counts"] == (per_chunk if v2 else 0),
          f"{label}: not one launch a chunk of K1, K6 (and K8) {launches}")
    # v1 packs its plain blocks on the card, two launches a chunk; v2 on
    # the host
    check(launches["pack"] == (0 if v2 else 2 * per_chunk),
          f"{label}: the packer did not launch twice a chunk on v1 and never "
          f"on v2 {launches}")
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
                partitioned_share=part_share, stream=buf)


def pack_case(torch, ops_pack, ops_rice, bitio, vals, ks, nv, max_words,
              label) -> int:
    """The packer's wrapper on the card against its plain version on the
    card, exactly, and against the host packer's words (up to max_words a
    row); returns the largest difference (0)."""
    dev = torch.device("cuda")
    v, k, n = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
               for a in (vals, ks, nv))
    got = ops_pack.pack_blocks(v, k, n, max_words)
    valid = torch.arange(v.shape[1], device=dev)[None, :] < n[:, None]
    want = ops_pack.pack_blocks_reference(
        torch.where(valid, ops_rice.zigzag(v), 0), k, n, max_words)
    torch.cuda.synchronize()
    err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    exact = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    words, counts = bitio.pack_blocks_flat(
        vals[np.arange(vals.shape[1])[None, :] < nv[:, None]],
        np.concatenate([[0], np.cumsum(nv.astype(np.int64))[:-1]]), nv, ks)
    dense = got[0].cpu().numpy().view(np.uint32)
    ends = np.cumsum(counts)
    host = (np.array_equal(got[1].cpu().numpy(), counts) and all(
        np.array_equal(dense[b, : min(c, max_words)], words[e - c : e - c
                                                            + min(c, max_words)])
        for b, (c, e) in enumerate(zip(counts, ends))))
    over = int((counts > max_words).sum())
    log(f"packer {label} [{len(nv)}, {vals.shape[1]}] max_words {max_words}: "
        f"exact={exact} max_abs_err={err} host packer's words={host} (rows over "
        f"max_words {over}, words {int(counts.sum())})")
    check(exact and host, f"the packer disagrees ({label})")
    return err


def phase_pack(torch, pipeline, encoder, ops_pack, ops_rice, k_pack, bitio,
               cd) -> dict:
    log("== phase 10: the Rice packer (csrc/pack.cu) against its plain version "
        "and the host packer")
    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    # (a) one 512-frame chunk of the cd_180s v1 encode, its residues at
    # their planned k (v1 has no partitioned rows; escape rows are left out)
    x, nv_f = encoder.frame_batches(cd)
    out = pipeline.encode_step(torch.from_numpy(x[:512]).to(dev),
                               torch.from_numpy(nv_f[:512]).to(dev))
    k_all = out["k_res"].reshape(-1).cpu().numpy()
    sel = np.flatnonzero(k_all <= 30)
    vals = out["residues"].reshape(-1, FRAME).cpu().numpy()[sel]
    ks = k_all[sel]
    nv = np.repeat(nv_f[:512], 2)[sel]
    planned = out["nw_res"].reshape(-1).cpu().numpy()[sel]
    mw = int(planned.max())
    log(f"(a) cd_180s chunk 0: {len(sel)} of {len(k_all)} rows plain (escapes "
        f"{int((k_all == 31).sum())}), k {np.bincount(ks, minlength=31).tolist()}")
    errs = [pack_case(torch, ops_pack, ops_rice, bitio, vals, ks, nv, mw,
                      "(a) cd_180s chunk 0")]
    # the packer's word counts are the device plan's (K6's nw_res)
    counts = ops_pack.pack_blocks(*(torch.from_numpy(a).to(dev)
                                    for a in (vals, ks, nv)), mw)[1]
    check(np.array_equal(counts.cpu().numpy(), planned),
          "the packer's word counts differ from the plan's nw_res")
    # (b) forced k, values up to a few bits past the k's range
    for kf in (0, 1, 5, 13, 30):
        amp = 1 << min(kf + 3, 31)
        vb = rng.integers(-amp, amp, (132, FRAME), dtype=np.int64).astype(np.int32)
        kb, nb = np.full(132, kf, np.int32), np.full(132, FRAME, np.int32)
        mwb = int(ops_pack.pack_blocks(*(torch.from_numpy(a) for a in (vb, kb, nb)),
                                       1)[1].max())
        errs.append(pack_case(torch, ops_pack, ops_rice, bitio, vb, kb, nb, mwb,
                              f"(b) k={kf}"))
    # (c) the edges: 1,027 rows, n_valid on a thread's and a warp's edges,
    # k = 30 rows whose patterns straddle words, rows over max_words, and
    # the word buffer in the output row (max_words > 12,000)
    B = 1027
    scale = 10.0 ** rng.uniform(0, 6, (B, 1))
    vc = np.clip(np.round(rng.laplace(0, 1, (B, FRAME)) * scale),
                 -(1 << 31), (1 << 31) - 1).astype(np.int32)
    vc[3::11] = np.resize(np.array([(1 << 30) - 1, -(1 << 30), 1, 0, -1, 7],
                                   np.int32), FRAME)
    nc = np.resize(np.array([0, 1, 31, 32, 33, FRAME - 1, FRAME], np.int32), B)
    # k from 3 below to 1 above each row's scale: unary runs of up to ~2^4
    kc = np.clip(np.log2(scale[:, 0]).astype(np.int32)
                 + rng.integers(-3, 2, B), 0, 30).astype(np.int32)
    kc[3::11] = 30
    full = int(ops_pack.pack_blocks(*(torch.from_numpy(a) for a in (vc, kc, nc)),
                                    1)[1].max())
    for mwc in (64, full, 12001):
        errs.append(pack_case(torch, ops_pack, ops_rice, bitio, vc, kc, nc, mwc,
                              "(c) edges"))

    # timing on (a): the launcher (the wrapper reads k, a sync)
    v, k, n = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
               for a in (vals, ks, nv))
    ms = time_kernel(torch, lambda: k_pack.pack_blocks_cuda(v, k, n, mw), 200)
    # cold: 7 copies of the values (8.4 MB each) and each call's words kept
    # until its copy comes round again exceed the L2 between two uses
    copies = [v.clone() for _ in range(7)]
    ring = [None] * len(copies)
    calls = iter(range(1 << 30))

    def cold_call(vx):
        i = next(calls) % len(ring)
        ring[i] = None
        ring[i] = k_pack.pack_blocks_cuda(vx, k, n, mw)

    cold = time_kernel_cold(torch, cold_call, copies, 200)
    del copies, ring
    valid = torch.arange(FRAME, device=dev)[None, :] < n[:, None]
    plain = time_plain(torch, lambda: ops_pack.pack_blocks_reference(
        torch.where(valid, ops_rice.zigzag(v), 0), k, n, mw), 3)
    rows_ms = {}   # time against rows: 1 row is the launch and one row's chain
    for b in (1, 132, len(sel)):
        a_r = [t[:b].contiguous() for t in (v, k, n)]
        rows_ms[b] = time_kernel(
            torch, lambda: k_pack.pack_blocks_cuda(*a_r, mw), 200)
    flat = vals[np.arange(FRAME)[None, :] < nv[:, None]]
    offs = np.concatenate([[0], np.cumsum(nv.astype(np.int64))[:-1]])
    host_s = min(timed_once(lambda: bitio.pack_blocks_flat(flat, offs, nv, ks))
                 for _ in range(5))
    bms, by = pack_bound(nv, FRAME, mw)
    log(f"packer [{len(sel)}, {FRAME}] max_words {mw}: kernel {ms:.5f} ms (warm "
        f"L2), {cold:.5f} ms (cold, 7 copies), plain {plain:.3f} ms, host "
        f"packer {host_s * 1e3:.3f} ms, bound {bms:.5f} ms ({by}): share "
        f"{share(bms, ms):.3f} warm, {share(bms, cold):.3f} cold; rows "
        + ", ".join(f"{b}: {t:.5f} ms" for b, t in rows_ms.items()))
    at = pack_at_chunk(torch, encoder, ops_pack, k_pack, out, nv_f[:512])
    return dict(rows=len(sel), max_words=mw, max_abs_err=max(errs), exact=True,
                ms=ms, cold_ms=cold, plain_ms=plain, bound_ms=bms, bound_by=by,
                cold_share=share(bms, cold), rows_ms=rows_ms,
                host_pack_ms=host_s * 1e3, pack_at=at)


def pack_at_bound(nv: np.ndarray, N: int, words: int) -> tuple[float, str]:
    """sela_pack_at on these rows: reads the values up to n_valid, k,
    n_valid, cap and the 64-bit offset, writes the planned words and a
    64-bit nwords a row; its per-value work."""
    valid = np.clip(nv.astype(np.int64), 0, N).sum()
    return bound_ms(valid * 4 + len(nv) * (4 + 4 + 4 + 8 + 8) + words * 4,
                    valid * PACK_VALUE_OPS)


def pack_at_chunk(torch, encoder, ops_pack, k_pack, out, nv_f) -> dict:
    """The encoder's packer entry (sela_pack_at) as encode_wav launches it
    on a chunk (encoder.device_pack): its two launches' words and counts
    against the plain version, exactly, and against the plan's word counts;
    each launch timed warm, beside its bound."""
    dev = torch.device("cuda")
    nv_d = torch.from_numpy(np.ascontiguousarray(nv_f)).to(dev)
    got = encoder.device_pack(out, nv_d)
    cpu = {k: v.cpu() for k, v in out.items()}
    want = encoder.device_pack(cpu, nv_d.cpu())
    torch.cuda.synchronize()
    B = len(nv_f) * out["residues"].shape[1]
    res = {}
    for i, (kind, values, ks, counts, planned) in enumerate((
            ("residues", out["residues"], out["k_res"], nv_d.repeat_interleave(
                out["residues"].shape[1]), out["nw_res"]),
            ("coefficients", out["qcoeffs"], out["k_coeff"], out["order"],
             out["nw_coeff"]))):
        words, nwords = got[2 * i], got[2 * i + 1]
        plan = planned.reshape(B).cpu().numpy()
        total = int(plan.sum())
        plain = want[2 * i + 1].numpy() >= 0
        exact = (torch.equal(nwords.cpu(), want[2 * i + 1])
                 and torch.equal(words[:total].cpu(), want[2 * i][:total])
                 and np.array_equal(nwords.cpu().numpy()[plain], plan[plain]))
        check(exact, f"sela_pack_at ({kind}) differs from its plain version "
              f"or the plan")
        # the launch alone, on the inputs device_pack gives it
        v = values.reshape(B, -1).contiguous()
        k = ks.reshape(B).contiguous()
        n = counts.reshape(B).contiguous()
        caps = planned.reshape(B).contiguous()
        offs = torch.cumsum(caps, 0, dtype=torch.int64) - caps
        buf = torch.empty(v.numel(), dtype=torch.int32, device=dev)
        ms = time_kernel(torch, lambda: k_pack.pack_blocks_at_cuda(
            v, k, n, offs, caps, buf), 200)
        bms, by = pack_at_bound(n.cpu().numpy(), v.shape[1], total)
        log(f"sela_pack_at {kind} [{B}, {v.shape[1]}], {total} words, "
            f"{int((~plain).sum())} rows left to the host: exact={exact}; "
            f"kernel {ms:.5f} ms (warm L2), bound {bms:.5f} ms ({by}), share "
            f"{share(bms, ms):.3f}")
        res[kind] = dict(rows=B, words=total, ms=ms, bound_ms=bms,
                         bound_by=by, share=share(bms, ms), exact=exact)
    return res


def timed_once(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def phase_slice(torch, bench, decoder, stream, WavData, k_lpc, k_iir, k_enc,
                k_pack, cd, dec_main, enc_main) -> dict:
    log("== phase 11: the slice's paths on the card (bench, corpus, stream, "
        "packer A/B, device pipeline)")
    w = WavData(44100, 16, cd)
    e2e = bench.bench_e2e(w, iters=3, label="cd_180s", device="cuda")
    log(f"cd_180s min of 3 walls: encode v1 {e2e['encode_s']:.4f} s, decode "
        f"{e2e['decode_s']:.4f} s (single walls of phases 8 and 7: "
        f"{enc_main['wall_s']:.4f} and {dec_main['wall_s']:.4f} s)")

    reset_launches(k_lpc, k_iir, k_enc)
    batch = bench.bench_batch64(iters=3, device="cuda")
    launches = {"lpc": k_lpc.launches, **k_enc.launches, "iir": k_iir.launches}
    log(f"batch64: encode {batch['encode_s']:.4f} s, decode "
        f"{batch['decode_s']:.4f} s (min of 3; one file at a time "
        f"{batch['per_file_encode_s']:.4f} and "
        f"{batch['per_file_decode_s']:.4f} s), ratio "
        f"{batch['compression_ratio']:.4f}, bit-exact; launches {launches}")
    check(all(launches[k] > 0 for k in ENCODE_KERNELS + ("iir",)),
          f"batch64: a kernel was not launched {launches}")

    buf = enc_main["stream"]
    want = decoder.decode_sela(buf, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = stream.decode_stream(buf, device="cuda")
    first = next(blocks)
    t_first = time.perf_counter() - t0
    rest = list(blocks)
    t_total = time.perf_counter() - t0
    pcm = np.concatenate([first, *rest])
    same = all(np.array_equal(pcm[:, c], want.channels[c]) for c in range(2))
    log(f"decode_stream cd_180s (128-frame chunks): {1 + len(rest)} blocks, "
        f"time to first block {t_first * 1e3:.2f} ms, total {t_total:.4f} s; "
        f"the blocks equal decode_sela's PCM: {same}")
    check(same, "decode_stream's blocks differ from decode_sela's PCM")

    host = bench.bench_host_pack(n_blocks=ROWS_MAIN, n_vals=FRAME)
    k_pack.launches = 0
    dp = bench.bench_device_pack(n_blocks=ROWS_MAIN, n_vals=FRAME,
                                 device="cuda")
    dp_launches = k_pack.launches
    log(f"packer A/B at [{ROWS_MAIN}, {FRAME}]: kernel {dp['kernel_ms']:.5f} "
        f"ms, kernel + D2H of its words {dp['kernel_and_fetch_s'] * 1e3:.4f} ms,"
        f" host packer {dp['host_pack_s'] * 1e3:.4f} ms (bench_host_pack: "
        f"{host['pack_s'] * 1e3:.4f} ms, counting {host['count_s'] * 1e3:.4f} "
        f"ms, unpack {host['unpack_s'] * 1e3:.4f} ms); fetch "
        f"{dp['fetch_bytes_device_pack']} B of words against "
        f"{dp['fetch_bytes_host_pack']} B of int16 residues; packer launches "
        f"{dp_launches}")
    check(dp_launches > 0, "bench_device_pack did not launch the packer")
    pipe = bench.bench_device_pipeline(60.0, chunk_frames=512, n_chunks=8,
                                       device="cuda")
    log(f"device pipeline 512 x 8 frames: encode {pipe['encode_s'] * 1e3:.3f} "
        f"ms ({pipe['encode_gbps']:.2f} GB/s), decode "
        f"{pipe['decode_s'] * 1e3:.3f} ms ({pipe['decode_gbps']:.2f} GB/s), "
        f"round trip bit-exact")
    return dict(e2e=e2e, batch=batch, batch_launches=launches,
                stream_first_ms=t_first * 1e3, stream_total_s=t_total,
                host_pack=host, device_pack=dp, device_pack_launches=dp_launches,
                pipeline=pipe)


LONG_S = 1200.0   # phase 12's track: 20 minutes, 25,840 frames
# the `kernels` line's names -> their launch counters on phase 12's path
SHARDED_NAMES = {"lpc_from_q": "lpc", "iir_synthesize": "iir",
                 "autocorr": "autocorr", "levinson": "levinson",
                 "fir_rice": "fir_rice", "ksel": "ksel",
                 "quarter_counts": "quarter_counts"}


def step_ms(torch, fn):
    """A timed call of fn, which must not wait on the device, after an
    untimed one (the first launch of a kernel loads its module, which can
    wait on the device): (its result, device ms between two CUDA events
    queued behind a ~100 ms device-side sleep that covers the host's
    enqueue, host ms of the enqueue). An enqueue past the sleep would put
    host gaps into the device time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    return out, start.elapsed_time(end), enqueue_ms


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """Shard workers (`python -m sela_tpu_torch.parallel.shard_worker`) on
    the card as processes of this script: each is killed on exit if still
    running."""

    def __init__(self):
        self.procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for _, p in self.procs:
            if p.poll() is None:
                p.kill()
            p.communicate()

    def spawn(self, wav: str, out_dir: str, rank: int, n: int,
              port: int | None, extra=()):
        """One rank: in a gloo group of n on 127.0.0.1:port, or alone with
        --rank (port None)."""
        args = (["--rank", str(rank), "--n-hosts", str(n)]
                if port is None else [])
        env = dict(os.environ, LOCAL_RANK=str(rank))
        if port is not None:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(n), RANK=str(rank))
        p = subprocess.Popen(
            [sys.executable, "-m", "sela_tpu_torch.parallel.shard_worker",
             wav, out_dir, *args, *extra], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.procs.append((time.perf_counter(), p))
        return p

    def finish(self, procs: list, timeout: float = 600.0) -> list[dict]:
        """Wait for procs; each one's JSON line with its process wall
        (spawn to exit) added as process_s."""
        t0 = {id(p): t for t, p in self.procs}
        ends = {}
        deadline = time.perf_counter() + timeout
        while len(ends) < len(procs):
            for p in procs:
                if id(p) not in ends and p.poll() is not None:
                    ends[id(p)] = time.perf_counter()
            check(time.perf_counter() < deadline, "a shard worker hung")
            time.sleep(0.005)
        lines = []
        for p in procs:
            out, err = p.communicate()
            check(p.returncode == 0,
                  f"shard worker exited {p.returncode}: {err[-2000:]}")
            line = json.loads(out.strip().splitlines()[-1])
            line["process_s"] = ends[id(p)] - t0[id(p)]
            lines.append(line)
        return lines


def wait_joined(p, timeout: float = 300.0) -> None:
    """Read a worker's stderr on a thread until it has joined its group."""
    import queue
    import threading

    lines = queue.Queue()

    def drain():
        for line in p.stderr:
            lines.put(line)
        lines.put("")

    threading.Thread(target=drain, daemon=True).start()
    deadline = time.perf_counter() + timeout
    while True:
        line = lines.get(timeout=max(deadline - time.perf_counter(), 0.01))
        if line.startswith("joined rank"):
            return
        check(bool(line), "the worker to kill exited before joining")


def phase_parallel(torch, encoder, decoder, WavData, Metrics, k_lpc, k_iir,
                   k_enc, cd, c32) -> dict:
    """Phase 12: the frame-axis sharded steps and the multi-process shard
    encode on a track of LONG_S seconds tiled from `cd`."""
    import hashlib
    import tempfile

    from sela_tpu_torch.parallel import mesh, multihost
    from sela_tpu_torch.ref.wav import write_wav

    log("== phase 12: the parallel paths (sharded steps, shard encode "
        "across processes)")
    n = int(round(LONG_S * 44100))
    long = [np.tile(c, -(-n // len(c)))[:n] for c in cd]
    w = WavData(44100, 16, long)
    pcm_bytes = n * 2 * 2
    x, nv = encoder.frame_batches(long, dtype=np.int16)
    x = torch.from_numpy(np.ascontiguousarray(x)).cuda()
    nv = torch.from_numpy(nv).cuda()
    F = x.shape[0]
    log(f"(a) long track: {LONG_S:.0f} s of 16-bit/44.1 kHz stereo tiled "
        f"from cd_180s, {n} samples, {F} frames, {pcm_bytes / 1e6:.2f} MB of "
        f"PCM; {F * 4} candidate rows of {FRAME} samples "
        f"({F * 4 * FRAME / 1e6:.1f} M int32 elements)")

    # (b) the sharded steps, every launch counted
    reset_launches(k_lpc, k_iir, k_enc)
    torch.cuda.reset_peak_memory_stats()
    all_cards = mesh.data_mesh()
    t0 = time.perf_counter()
    enc_dry = mesh.dryrun_multichip(all_cards, x, nv)
    log(f"(b) dryrun_multichip over {all_cards.size} device(s) "
        f"{[str(d) for d in all_cards.devices]}: the unsharded integer render "
        f"of the sharded planning equals it on {', '.join(mesh.RENDER_CHECKS)}"
        f"; the round trip is bit-exact ({time.perf_counter() - t0:.2f} s "
        f"host wall, first use)")
    four = mesh.data_mesh(devices=[all_cards.devices[0]] * 4)
    steps = {}

    def timed(label, fn, nbytes):
        out, ms, enqueue_ms = step_ms(torch, fn)
        steps[label] = dict(ms=ms, gb_per_s=nbytes / ms / 1e6,
                            enqueue_ms=enqueue_ms)
        gaps = "; past the sleep: host gaps" if enqueue_ms > 90 else ""
        log(f"  {label}: {ms:.3f} ms device, {nbytes / ms / 1e6:.2f} GB/s "
            f"of PCM (host enqueue {enqueue_ms:.2f} ms{gaps})")
        return out

    enc1 = timed("encode v2, 1 shard",
                 lambda: mesh.sharded_encode_step(all_cards, partition=4)(x, nv),
                 pcm_bytes)
    enc4 = timed("encode v2, 4 shards",
                 lambda: mesh.sharded_encode_step(four, partition=4)(x, nv),
                 pcm_bytes)
    same = [k for k in enc1 if torch.equal(enc1[k], enc4[k])
            and torch.equal(enc1[k], enc_dry[k])]
    log(f"  4-way and 1-way planning identical on {len(same)}/{len(enc1)} "
        f"keys (and to the dry run's)")
    check(len(same) == len(enc1), "4-way sharded planning differs from 1-way "
          f"on {sorted(set(enc1) - set(same))}")
    pcm1, exact1 = timed("codec v1, 1 shard",
                         lambda: mesh.sharded_codec_step(all_cards)(x, nv),
                         pcm_bytes)
    pcm4, exact4 = timed("codec v1, 4 shards",
                         lambda: mesh.sharded_codec_step(four)(x, nv),
                         pcm_bytes)
    check(bool(exact1.all()) and bool(exact4.all())
          and torch.equal(pcm1, pcm4),
          "a sharded codec step is not bit-exact or the shardings differ")
    del enc1, enc4, enc_dry, pcm1, pcm4
    x32, nv32 = encoder.frame_batches(c32, dtype=np.int32)
    x32 = torch.from_numpy(np.ascontiguousarray(x32)).cuda()
    nv32 = torch.from_numpy(nv32).cuda()
    _, exact32 = timed(f"codec 32-bit (int32_10s, {x32.shape[0]} frames, "
                       f"allow_ms=False), 4 shards, padded by "
                       f"{(-x32.shape[0]) % 4}",
                       lambda: mesh.sharded_codec_step(four, allow_ms=False)(
                           x32, nv32), x32.numel() * 4)
    check(bool(exact32.all()), "the 32-bit sharded codec step is not exact")
    sharded = {"lpc": k_lpc.launches, **k_enc.launches, "iir": k_iir.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  sharded launches {sharded}; peak device memory {peak:.2f} GiB")
    check(all(v > 0 for v in sharded.values()),
          f"a kernel did not run on the sharded path {sharded}")
    del x, nv, x32, nv32

    # (c) shard encode across processes, (d) kill and recover
    cores = len(os.sched_getaffinity(0))
    log(f"(c) shard encode across processes: {cores} host cores; the ranks "
        f"share one card and these cores, so this measures how far the "
        f"host-bound encode scales on one machine, not multi-host scaling")
    with tempfile.TemporaryDirectory() as tmp, Ranks() as ranks:
        wav = os.path.join(tmp, "long.wav")
        write_wav(wav, w)
        walls = []
        for _ in range(2):   # this process's first encode of the size, again
            m = Metrics()
            t0 = time.perf_counter()
            single = encoder.encode_wav(w, device="cuda", metrics=m)
            walls.append(time.perf_counter() - t0)
            log(f"  encode_wav of the track in this process: {walls[-1]:.3f} s "
                f"= {pcm_bytes / walls[-1] / 1e6:.1f} PCM MB/s; stages "
                f"{ {k: round(v, 3) for k, v in m.stage_s.items()} }")
        single_s = walls[0]
        digest = hashlib.sha256(single).hexdigest()
        log(f"  {len(single)} bytes, sha256 {digest[:16]}")
        runs = {}
        for n_ranks in (1, 2, 4):
            out = os.path.join(tmp, f"shards{n_ranks}")
            port = free_port()
            lines = ranks.finish([ranks.spawn(wav, out, r, n_ranks, port)
                                  for r in range(n_ranks)])
            merged = os.path.join(tmp, f"merged{n_ranks}.sela")
            info = multihost.merge_shards(out, n_ranks, merged)
            with open(merged, "rb") as f:
                buf = f.read()
            ok = hashlib.sha256(buf).hexdigest() == digest
            manifests = [json.load(open(multihost._manifest_path(out, r)))
                         for r in range(n_ranks)]
            runs[n_ranks] = dict(lines=lines, info=info, manifests=manifests)
            t1 = runs[1]["info"]["wall_max_s"]
            p1 = max(d["process_s"] for d in runs[1]["lines"])
            eff = multihost.scaling_efficiency(t1, manifests)
            p_eff = p1 / (n_ranks * max(d["process_s"] for d in lines))
            runs[n_ranks].update(efficiency=eff, process_efficiency=p_eff)
            log(f"  {n_ranks} rank(s): wall_s "
                f"{[round(d['wall_s'], 4) for d in lines]} (first use before "
                f"it {[round(d['first_use_s'], 3) for d in lines]}), process walls "
                f"{[round(d['process_s'], 3) for d in lines]} s; balance "
                f"{info['balance']}, aggregate {info['aggregate_mb_per_s']} "
                f"MB/s, scaling efficiency {eff:.4f} (process walls "
                f"{p_eff:.4f}); merged sha256 equals the single encode's: "
                f"{ok}")
            for d in lines:
                log(f"    rank {d['rank']}: stages {d['stages']}; launches "
                    f"{d['launches']}")
            check(ok, f"the {n_ranks}-rank merge differs from one encode_wav")
            check(all(d["launches"][k] > 0 for d in lines
                      for k in ENCODE_KERNELS),
                  f"a shard worker did not run the encode kernels {lines}")
            if n_ranks == 4:
                t0 = time.perf_counter()
                back = decoder.decode_sela(buf, device="cuda")
                same = all(np.array_equal(a, b)
                           for a, b in zip(back.channels, long))
                log(f"  decode_sela of the 4-rank merge gives the input: "
                    f"{same} ({time.perf_counter() - t0:.3f} s)")
                check(same, "the merged stream does not decode to the input")

        out = os.path.join(tmp, "killed")
        port = free_port()
        p0 = ranks.spawn(wav, out, 0, 2, port)
        p1 = ranks.spawn(wav, out, 1, 2, port, extra=("--slow-ms", "120000"))
        wait_joined(p1)
        p1.kill()
        p1.wait()
        ranks.finish([p0])
        missing = multihost.missing_shards(out, 2)
        check(missing == [1], f"(d) missing_shards gave {missing}, not [1]")
        ranks.finish([ranks.spawn(wav, out, 1, 2, None)])
        merged = os.path.join(tmp, "recovered.sela")
        multihost.merge_shards(out, 2, merged)
        with open(merged, "rb") as f:
            ok = hashlib.sha256(f.read()).hexdigest() == digest
        log(f"(d) rank 1 of 2 killed after joining: rank 0 exited 0, "
            f"missing_shards {missing}; rank 1 re-run alone; the merge's "
            f"sha256 equals the single encode's: {ok}")
        check(ok, "the recovered merge differs from one encode_wav")
    return dict(frames=F, steps=steps, sharded=sharded, peak_gib=peak,
                single_s=walls, cores=cores,
                runs={k: {kk: v[kk] for kk in ("info", "efficiency",
                                               "process_efficiency")}
                      | {"wall_s": [d["wall_s"] for d in v["lines"]],
                         "process_s": [d["process_s"] for d in v["lines"]]}
                      for k, v in runs.items()})


# K9 at the roofline tool's readings: (rows, T), the first its timed shape
CHAIN_READINGS = ((512, 1 << 19), (512, 1 << 16), (8, 1 << 20), (8, 1 << 23),
                  (2112, 1 << 16))
CHAIN_ADDEND = "0x3039"   # b = 12345, the addend of every chain step's IMAD


def chain_sass_loops(cuobjdump: str, lib: str) -> list[int]:
    """The chain steps in each loop of K9's static SASS: for every backward
    branch, the IMADs with the step's addend between its target and it. A
    reassociated pair of steps would be one IMAD with another addend."""
    import re

    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, timeout=120).stdout
    ins = [(int(a, 16), op) for a, op in re.findall(
        r"/\*([0-9a-f]{4})\*/\s+([^;]*);", sass)]
    imad = [a for a, op in ins if re.fullmatch(
        r"IMAD (R\d+), \1, R\d+(\.reuse)?, " + CHAIN_ADDEND, op.strip())]
    plain = [a for a, op in ins if re.match(r"IMAD\s", op.strip())]
    check(len(plain) == len(imad),
          f"K9's SASS has {len(plain) - len(imad)} IMADs other than the "
          "chain's steps")
    loops = []
    for a, op in ins:
        m = re.search(r"\bBRA (0x[0-9a-f]+)", op)
        if m and int(m.group(1), 16) < a:
            loops.append(sum(int(m.group(1), 16) <= x < a for x in imad))
    return loops


def phase_tools(torch, k_chain, k_lpc, k_iir, k_enc, build_dir, nvcc) -> dict:
    """Phase 13: K9 against its plain version and its SASS, then each tool
    of sela_tpu_torch.tools on the card."""
    import contextlib
    import io
    import tempfile

    from sela_tpu_torch import bench
    from sela_tpu_torch.ops.chain import int_chain, int_chain_reference
    from sela_tpu_torch.tools import (check_regression, measure_scaling,
                                      profile_stages, roofline, sweep_ratio)

    log("== phase 13: the tools (K9, roofline, profile_stages, sweep_ratio, "
        "measure_scaling, check_regression)")
    t_phase = time.perf_counter()
    dev = torch.device("cuda")

    def tool_line(main, argv) -> tuple[int, dict]:
        """A tool's main in this process: its exit code and its JSON line
        (stdout captured; stderr passes through)."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        lines = buf.getvalue().strip().splitlines()
        check(len(lines) == 1, f"{main.__module__} printed {len(lines)} "
              "lines on stdout, not one JSON line")
        return rc, json.loads(lines[0])

    # (a) K9 against its plain version, exactly
    rng = np.random.default_rng(9)
    err = 0
    for rows, steps in ((8, 1000), *CHAIN_READINGS):
        x = rng.integers(-(1 << 31), 1 << 31, (rows, 128), dtype=np.int64)
        x[0, :2] = (-(1 << 31), (1 << 31) - 1)
        xd = torch.from_numpy(x.astype(np.int32)).to(dev)
        got = int_chain(xd, steps)
        want = int_chain_reference(xd, steps)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        log(f"K9 [{rows}, 128] T={steps}: exact={e == 0}")
        check(e == 0, f"K9 disagrees with its plain version at [{rows}, 128], "
              f"T={steps}")
        err = max(err, e)
    rows, steps = CHAIN_READINGS[0]
    xd = torch.zeros((rows, 128), dtype=torch.int32, device=dev)
    ms = time_kernel(torch, lambda: int_chain(xd, steps), 10)
    plain = time_plain(torch, lambda: int_chain_reference(xd, steps), 5)
    bms, by = bound_ms(2 * rows * 128 * 4, rows * 128 * steps)
    log(f"K9 [{rows}, 128] T={steps}: kernel {ms:.4f} ms, plain {plain:.4f} ms,"
        f" bound {bms:.4f} ms ({by}), share {share(bms, ms):.3f}")
    k9 = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
              bound_by=by, shape=[rows, 128], steps=steps)

    # (b) one IMAD a chain step in the static SASS
    cuobjdump = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    loops = chain_sass_loops(cuobjdump, os.path.join(build_dir,
                                                     "libsela_int_chain.so"))
    log(f"K9 SASS: chain-step IMADs a loop {loops} (UNROLL "
        f"{k_chain.UNROLL}, then the remainder loop)")
    check(loops == [k_chain.UNROLL, 1],
          f"K9's loops hold {loops} chain-step IMADs, not "
          f"[{k_chain.UNROLL}, 1]: one IMAD a step is not what runs")
    k9["sass_imads_a_loop"] = loops

    # (c) the roofline tool in full: K9's main path
    k_chain.launches = 0
    reset_launches(k_lpc, k_iir, k_enc)
    t0 = time.perf_counter()
    rc, roof = tool_line(roofline.main, [])
    k9["launches"] = k_chain.launches
    i32 = roof["int32"]
    log(f"roofline ({time.perf_counter() - t0:.1f} s): IMADs a clock a SM "
        f"{i32['imad_per_clk_per_sm']:.2f} at [512, 128], "
        f"{i32['imad_per_clk_per_sm_fill']:.2f} at [2112, 128]; "
        f"{i32['imad_per_s']:.5g} and {i32['imad_per_s_fill']:.5g} IMAD/s "
        f"({i32['int32_tput_gops']:.1f} Gop/s in the JAX count); dependent "
        f"step {i32['dependent_step_ns']:.4f} ns = "
        f"{i32['dependent_step_cycles']:.3f} cycles at {i32['sm_clock_mhz']} "
        f"MHz; K9 launches {k_chain.launches}")
    log(f"roofline: IIR {roof['iir']}; encode kernels "
        f"{roof['encode_kernels']}; model {roof['model']}")
    log("roofline line: " + json.dumps(roof))
    check(rc == 0 and k_chain.launches > 0,
          f"the roofline tool failed or did not launch K9 (exit {rc})")
    k9["roofline"] = {k: i32[k] for k in (
        "imad_per_clk_per_sm", "imad_per_clk_per_sm_fill", "imad_per_s_fill",
        "dependent_step_ns", "dependent_step_cycles", "sm_clock_mhz")}

    # (d) every stage of profile_stages, --only, in this process
    t0 = time.perf_counter()
    stages = {}
    for name in profile_stages.STAGE_NAMES:
        rc, rec = tool_line(profile_stages.main, ["1024", "--only", name])
        check(rc == 0, f"profile_stages --only {name} failed")
        stages[name] = rec[name]
        log(f"  {name:18s} {rec[name]['ms']:9.4f} ms "
            f"{rec[name]['pcm16_gbps']:9.2f} GB/s-equiv")
    glue = profile_stages.glue(stages)
    log(f"profile_stages F=1024 ({time.perf_counter() - t0:.1f} s): "
        f"encode_step(fus) {glue['encode_step_ms']:.4f} ms, its kernels' "
        f"stages {glue['kernel_stages_ms']:.4f} ms, glue {glue['glue_ms']:.4f}"
        f" ms = {glue['glue_share']:.3f} of it")

    # (e) the ratio sweep on the card
    t0 = time.perf_counter()
    rc, sweep = tool_line(sweep_ratio.main, ["--seconds", "10"])
    log(f"sweep_ratio --seconds 10 ({time.perf_counter() - t0:.1f} s): "
        + json.dumps({k: v for k, v in sweep.items() if k != "device"}))
    check(rc == 0 and sweep["exact_order_stream_bits"]
          <= sweep["coeff_bit_cost_sweep_stream_bits"]["7"],
          "sweep_ratio failed, or the exact-order bits exceed the model's")

    # (f) the shard encode's scaling, pinned; the sha256 gate raises
    t0 = time.perf_counter()
    rc, scaling = tool_line(measure_scaling.main, ["--ranks", "2"])
    log(f"measure_scaling --ranks 2 ({time.perf_counter() - t0:.1f} s, exit "
        f"{rc}: {'at or above' if rc == 0 else 'below'} 0.80, a reading): "
        + json.dumps({k: v for k, v in scaling.items() if k != "device"}))
    check(scaling["runs"]["2"]["bit_exact_merge"],
          "measure_scaling: the 2-rank merge is not the single rank's bytes")

    # (g) the regression gate on a bench line of this run
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = bench.run_bench(20.0, "cuda", iters=1)
    log(f"bench line ({time.perf_counter() - t0:.1f} s): {out.getvalue().strip()}")
    grown = json.loads(json.dumps(line))
    for sub in grown["summary"].values():
        if isinstance(sub, dict) and "compression_ratio" in sub:
            sub["compression_ratio"] *= 1.2
    other = json.loads(json.dumps(line))
    other["device"]["name"] = "another device"
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, rec in (("line", line), ("grown", grown), ("other", other)):
            paths[name] = os.path.join(tmp, f"{name}.json")
            with open(paths[name], "w") as f:
                json.dump(rec, f)
        gate = {name: tool_line(check_regression.main, [
            "--previous", paths["line"], "--current", paths[name]])
            for name in ("line", "grown", "other")}
    log("check_regression: itself exit {}, ratios +20% exit {} ({} "
        "failures), another device exit {}".format(
            gate["line"][0], gate["grown"][0],
            len(gate["grown"][1].get("failures", [])), gate["other"][0]))
    check((gate["line"][0], gate["grown"][0], gate["other"][0]) == (0, 1, 2),
          "check_regression did not pass the line against itself, fail the "
          "grown ratios and refuse another device")
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return dict(k9=k9, roofline=roof, stages=stages, glue=glue,
                sweep_ratio=sweep, scaling=scaling)


# -------------------------------------------------------- hostile streams --

HOSTILE_SEED = 11
HOSTILE_MUTATIONS = 60    # a clip: 1-8 bytes XORed, every third in bytes 0-40
HOSTILE_HEADER = 40
HOSTILE_PATHS = ("decode_sela", "decode_stream", "decode_files")
HOSTILE_CHUNK_CPU = 8     # the CPU side, the plain versions: one chunk a clip
HOSTILE_CHUNK_CUDA = 1    # the card: every border of the four-frame clip
HOSTILE_WORKERS = 6
WRAP_RANGE = (-95390, 97155)   # the wrapping stream's samples, the oracle's


def hostile_clips() -> dict:
    """tests/test_torch_hostile.py's five base clips, encoded by the port's
    oracle, and the wrapping stream: the 16-bit mono clip with byte 27 ^= 5,
    whose first subframe becomes order 0 with k_res 15 and whose samples
    leave int16."""
    from sela_tpu_torch.config import BitstreamProfile
    from sela_tpu_torch.ref import codec as ref_codec
    from sela_tpu_torch.ref.wav import WavData

    rng = np.random.default_rng(0)
    clips = {"mono16": ref_codec.encode_wav(WavData(
        44100, 16, [rng.integers(-2000, 2000, 700).astype(np.int32)]))}
    rng = np.random.default_rng(2)
    left = rng.integers(-2000, 2000, 700).astype(np.int32)
    right = (left // 2 + rng.integers(-100, 100, 700)).astype(np.int32)
    clips["stereo16"] = ref_codec.encode_wav(WavData(44100, 16, [left, right]))
    rng = np.random.default_rng(4)
    burst = rng.integers(-20000, 20000, 100).astype(np.int32)
    quiet = rng.integers(-40, 40, 600).astype(np.int32)
    clips["partitioned16"] = ref_codec.encode_wav(
        WavData(44100, 16, [np.concatenate([burst, quiet, burst, quiet])]),
        profile=BitstreamProfile(residue_partition=4))
    rng = np.random.default_rng(5)
    t = np.arange(2000)
    tones = sum(a * np.sin(w * t + i) for i, (a, w) in enumerate(
        [(1, 0.031), (0.7, 0.077), (0.5, 0.19), (0.4, 0.43), (0.3, 0.9),
         (0.2, 1.6)]))
    left = np.round(1.5e6 * tones) + rng.integers(-40, 40, 2000)
    right = left * 0.6 + rng.integers(-300, 300, 2000)
    clips["stereo24"] = ref_codec.encode_wav(WavData(96000, 24, [
        left.astype(np.int32), np.round(right).astype(np.int32)]))
    rng = np.random.default_rng(6)
    t = np.arange(700)
    x = (np.round(1.5e9 * np.sin(0.05 * t))
         + rng.integers(-1 << 20, 1 << 20, 700)).astype(np.int64)
    x[100], x[400] = -(1 << 31), (1 << 31) - 1
    clips["mono32"] = ref_codec.encode_wav(
        WavData(48000, 32, [x.astype(np.int32)]))
    wrap = bytearray(clips["mono16"])
    wrap[27] ^= 5
    clips["wrap16"] = bytes(wrap)
    return clips


def hostile_corpus(clips: dict) -> list[tuple[str, bytes]]:
    """Each clip unmutated, then HOSTILE_MUTATIONS seeded mutations of each
    of the five base clips: 1 to 8 bytes XORed with 1-255, every third
    mutation inside the first HOSTILE_HEADER bytes (the file, frame and
    subframe headers of the mono clip)."""
    rng = np.random.default_rng(HOSTILE_SEED)
    out = list(clips.items())
    for name, base in clips.items():
        if name == "wrap16":
            continue
        for j in range(HOSTILE_MUTATIONS):
            hi = HOSTILE_HEADER if j % 3 == 0 else len(base) - 1
            buf = bytearray(base)
            for _ in range(int(rng.integers(1, 9))):
                buf[int(rng.integers(0, hi + 1))] ^= int(rng.integers(1, 256))
            out.append((name, bytes(buf)))
    return out


# The structure-aware mutator: mutations aimed at the fields of a valid
# stream, read from its parsed layout through the port's copy of the
# oracle's container code. tests/test_torch_hostile_fields.py imports these
# functions, so the CPU tests and phase 14 mutate the same way.

FIELD_TAGS = {"TITLE": "Hostile fields", "ARTIST": "sela", "TRACK": "7"}
FIELD_SEED = 13
FIELD_FLIPS = 3           # seeded aimed flips of each field of each clip
GROUP_CHUNK = 4           # decode_files' chunk in the group property: the
                          # three files share a chunk, and a multi-frame file
                          # crosses a border
HEADER_FIELDS = ("rate", "bits", "channels", "num_frames")
FRAME_FIELDS = ("sync", "num_samples", "channel", "type", "order", "k_coeff",
                "nw_coeff", "coeff_word", "k_res", "k_part", "nw_res",
                "res_word")
SETG_FIELDS = ("tag_magic", "tag_bytes", "tag_key_len", "tag_val_len",
               "tag_key")
APE_FIELDS = ("ape_preamble", "ape_version", "ape_size", "ape_count",
              "ape_flags", "ape_reserved", "ape_pair")
APE_BLOCK = (("ape_preamble", 0, 8), ("ape_version", 8, 4),
             ("ape_size", 12, 4), ("ape_count", 16, 4), ("ape_flags", 20, 4),
             ("ape_reserved", 24, 8))
# (b) field edits, re-serialized so that the scan gets past them, at the
# limits of FORMAT.md's decoder validation, and (c) the length changes that
# are not truncations: (field, edits, the base clips that the CPU tests aim
# them at, which phase 14 aims at every base clip; None: every base clip)
FIELD_EDITS = (
    ("order", ("32", "33", "255"), ("mono16", "stereo24", "mono32")),
    ("k_coeff", ("30", "31", "32", "255"), ("stereo24", "mono32")),
    ("k_res", ("30", "31", "32", "255"), ("stereo16", "partitioned16",
                                          "mono32")),
    ("k_part", ("31", "32"), None),
    ("coeff", ("63", "64", "-64", "-65"), None),
    ("num_samples", ("0", "1", "2048", "2049"), ("mono16", "partitioned16",
                                                 "stereo24")),
    ("channel", ("duplicate", "out_of_range"), None),
    ("type", ("3", "mid_at_odd", "side_without_mid", "mid_unpaired"), None),
    ("subframes", ("permuted",), None),
    ("nw_res", ("+1", "-1"), ("stereo16", "partitioned16", "mono32")),
    ("nw_res", ("last_short",), None),
    ("num_frames", ("+1", "-1"), None),
    ("trailer", ("junk", "second"), None),
)
# the edits of a clip with a tags trailer (its audio is a base clip's) and
# of the multi-frame clip (the edits that damage a frame, with the one
# valid reordering)
TAIL_EDITS = {"nw_res": ("last_short",), "num_frames": ("+1", "-1"),
              "trailer": ("junk", "second")}
MULTI_EDITS = {"order": ("33",), "k_coeff": ("32",), "coeff": ("64",),
               "num_samples": ("2049",), "channel": ("duplicate",),
               "type": ("3",), "subframes": ("permuted",),
               "nw_res": ("last_short",)}
MULTI_TRUNCATIONS = ("sync", "order", "coeff_word", "nw_res")


def field_clips(clips: dict) -> dict:
    """The mutator's base clips: hostile_clips' five base clips; mono16 and
    stereo24 each with a SeTg and an APEv2 tags trailer (FORMAT.md §Tags);
    and multi16, 16-bit stereo tones under noise in four frames of at most
    256 samples, with LPC orders above 0 and mid/side pairs, for the
    chunking properties."""
    from sela_tpu_torch.config import BitstreamProfile
    from sela_tpu_torch.ref import codec as ref_codec
    from sela_tpu_torch.ref import container
    from sela_tpu_torch.ref.wav import WavData

    out = {name: clips[name] for name in
           ("mono16", "stereo16", "partitioned16", "stereo24", "mono32")}
    for name in ("mono16", "stereo24"):
        for fmt in ("setg", "apev2"):
            out[f"{name}_{fmt}"] = container.replace_tags(clips[name],
                                                          FIELD_TAGS, fmt)
    rng = np.random.default_rng(7)
    t = np.arange(1000)
    left = (np.round(9000 * np.sin(0.07 * t) + 4000 * np.sin(0.31 * t + 1))
            + rng.integers(-60, 60, 1000))
    right = np.round(0.8 * left) + rng.integers(-200, 200, 1000)
    out["multi16"] = ref_codec.encode_wav(
        WavData(44100, 16, [left.astype(np.int32), right.astype(np.int32)]),
        profile=BitstreamProfile(frame_size=256))
    return out


def stream_fields(buf: bytes) -> dict:
    """The fields of a stream the oracle accepts (FORMAT.md's layout and its
    tags trailers): {field: [(frame, spans), ...]}, one entry an instance.
    frame is the frame's index, -1 in the file header and the frame count
    in the trailer; spans are (offset, length) pairs of one length, two
    for ape_pair (one field of the APEv2 header and of its footer)."""
    from sela_tpu_torch.format import (
        RESIDUE_PARTS, RICE_PARTITION_MARKER, TAG_MAGIC)
    from sela_tpu_torch.ref import container

    fields: dict = {}

    def add(name, frame, *spans):
        fields.setdefault(name, []).append((frame, spans))

    for name, off, n in zip(HEADER_FIELDS, (4, 8, 10, 11), (4, 2, 1, 4)):
        add(name, -1, (off, n))
    h = container.parse_header(buf)
    pos = container.HEADER_SIZE
    for f in range(h.num_frames):
        add("sync", f, (pos, 4))
        add("num_samples", f, (pos + 4, 2))
        ns = int.from_bytes(buf[pos + 4 : pos + 6], "little")
        pos += 6
        for _ in range(h.channels):
            sf, end = container.parse_subframe(buf, pos, ns)
            for i, name in enumerate(("channel", "type", "order", "k_coeff")):
                add(name, f, (pos + i, 1))
            add("nw_coeff", f, (pos + 4, 2))
            pos += 6
            for i in range(len(sf.coeff_words)):
                add("coeff_word", f, (pos + 4 * i, 4))
            pos += 4 * len(sf.coeff_words)
            add("k_res", f, (pos, 1))
            if sf.k_res == RICE_PARTITION_MARKER:
                for i in range(RESIDUE_PARTS):
                    add("k_part", f, (pos + 1 + i, 1))
                pos += RESIDUE_PARTS
            add("nw_res", f, (pos + 1, 4))
            pos += 5
            for i in range(len(sf.res_words)):
                add("res_word", f, (pos + 4 * i, 4))
            pos = end
    F = h.num_frames
    if buf[pos : pos + 4] == TAG_MAGIC:
        add("tag_magic", F, (pos, 4))
        add("tag_bytes", F, (pos + 4, 4))
        p = pos + 8
        while p < len(buf):
            klen = int.from_bytes(buf[p : p + 2], "little")
            vlen = int.from_bytes(buf[p + 2 : p + 6], "little")
            add("tag_key_len", F, (p, 2))
            add("tag_val_len", F, (p + 2, 4))
            add("tag_key", F, (p + 6, klen))
            p += 6 + klen + vlen
    elif pos < len(buf):   # APEv2: a header block, the items, a footer
        foot = len(buf) - 32
        for name, rel, n in APE_BLOCK:
            add(name, F, (pos + rel, n))
            add(name, F, (foot + rel, n))
            add("ape_pair", F, (pos + rel, n), (foot + rel, n))
    return fields


def aimed_flip(buf: bytes, fields: dict, name: str, pick) -> bytes:
    """(a) An instance of field `name`, a byte inside it, XORed with 1-255
    (the same byte in each span of the instance). pick(n) draws an index
    below n: hypothesis' draws in the tests, a seeded rng on the card."""
    _, spans = fields[name][pick(len(fields[name]))]
    i, x = pick(spans[0][1]), 1 + pick(255)
    out = bytearray(buf)
    for off, _ in spans:
        out[off + i] ^= x
    return bytes(out)


def _parse_stream(buf: bytes):
    from sela_tpu_torch.ref import container

    h = container.parse_header(buf)
    pos, frames = container.HEADER_SIZE, []
    for _ in range(h.num_frames):
        subframes, ns, pos = container.parse_frame(buf, pos, h.channels)
        frames.append([subframes, ns])
    return h, frames, bytes(buf[pos:])


def field_edit(buf: bytes, field: str, edit: str) -> bytes | None:
    """(b) and (c): buf, a stream the oracle accepts, with one field edited
    and re-serialized by the port's container code (a quantized coefficient
    re-Rice-encoded with its k and nWordsCoeff, so that only the range
    check can refuse it), or with its length changed; None where the edit
    does not apply to the stream. The edited subframe is in frame (F - 1)
    // 2, the last of its subframes with an LPC order above 0 (or its last
    subframe)."""
    from sela_tpu_torch.format import (
        RESIDUE_PARTS, RICE_PARTITION_MARKER, SF_DIRECT, SF_MID, SF_SIDE)
    from sela_tpu_torch.ref import container, rice

    h, frames, tail = _parse_stream(buf)
    C = h.channels
    subframes = frames[(len(frames) - 1) // 2][0]
    sf = ([s for s in subframes if s.order] or subframes)[-1]
    by_channel = {s.channel: s for s in subframes}
    value = int(edit) if edit.lstrip("+-").isdigit() else None
    if field == "order":
        sf.order = value
    elif field == "k_coeff":
        sf.k_coeff = value
    elif field == "k_res":
        if sf.k_res == value:
            return None
        if value == RICE_PARTITION_MARKER:   # the same k for every part
            sf.k_res_sub = [sf.k_res] * RESIDUE_PARTS
        sf.k_res = value
    elif field == "k_part":
        if sf.k_res != RICE_PARTITION_MARKER:
            return None
        sf.k_res_sub = [*sf.k_res_sub[:-1], value]
    elif field == "coeff":
        if not sf.order:
            return None
        q = rice.decode(sf.coeff_words, sf.order, sf.k_coeff)
        q[-1] = value
        sf.k_coeff, sf.coeff_words = rice.encode(q)
    elif field == "num_samples":
        frames[(len(frames) - 1) // 2][1] = value
    elif field == "channel":
        if edit == "out_of_range":
            sf.channel = C
        elif C < 2:
            return None
        else:
            subframes[-1].channel = subframes[0].channel
    elif field == "type":
        if edit == "3":
            sf.sftype = 3
        elif edit == "mid_unpaired":
            if C % 2 == 0:
                return None
            by_channel[C - 1].sftype = SF_MID
        else:
            if C < 2:
                return None
            by_channel[0].sftype = SF_DIRECT
            by_channel[1].sftype = (SF_MID if edit == "mid_at_odd"
                                    else SF_SIDE)
    elif field == "subframes":   # FORMAT.md: any order within a frame
        if C < 2:
            return None
        subframes.reverse()
    elif field == "nw_res":
        if edit == "+1":
            sf.res_words = np.append(sf.res_words, np.uint32(0x5A5A5A5A))
        elif edit == "-1":
            sf.res_words = sf.res_words[:-1]
        else:   # last_short: the count one word short, the word left behind
            last = frames[-1][0][-1]
            if not len(last.res_words):
                return None
            tail = last.res_words[-1:].astype("<u4").tobytes() + tail
            last.res_words = last.res_words[:-1]
    elif field == "num_frames":
        h.num_frames += value
    elif field == "trailer":
        if edit == "second" and not tail:
            return None
        tail += tail if edit == "second" else b"JUNK\x00\xff"
    else:
        raise ValueError(f"no field edit {field} {edit}")
    return container.serialize_file(h, [
        container.serialize_frame(s, ns) for s, ns in frames]) + tail


def field_truncation(buf: bytes, fields: dict, field: str,
                     inside: bool) -> bytes | None:
    """(c) buf cut at the start of `field` (its first instance in frame
    (F - 1) // 2, else its first instance), or inside it, at its middle
    byte; None for a one-byte field cut inside, or a field buf lacks."""
    if field not in fields:
        return None
    target = (fields["sync"][-1][0] // 2) if "sync" in fields else 0
    spans = next((sp for f, sp in fields[field] if f == target),
                 fields[field][0][1])
    off, n = spans[0]
    if inside and n < 2:
        return None
    return buf[: off + (n // 2 if inside else 0)]


def field_cases(clips: dict, every_clip: bool = False
                ) -> list[tuple[str, str, str]]:
    """The deterministic mutations of each field clip, as (clip, field,
    edit): the edits of FIELD_EDITS that apply to a base clip and are aimed
    at it (every_clip: all that apply), the tail edits of a tagged clip and
    MULTI_EDITS on the multi-frame clip; then truncations (edit
    "truncate_at" or "truncate_inside") at each field of the file header
    and the edited frame (the multi-frame clip: MULTI_TRUNCATIONS, at the
    field's start) and of the tags trailer."""
    cases = []
    for name, buf in clips.items():
        tagged = name.endswith(("_setg", "_apev2"))
        scope = (TAIL_EDITS if tagged else MULTI_EDITS
                 if name == "multi16" else None)
        for field, edits, aimed in FIELD_EDITS:
            for edit in edits:
                if scope is not None:
                    if edit not in scope.get(field, ()):
                        continue
                elif not (every_clip or aimed is None or name in aimed):
                    continue
                if field_edit(buf, field, edit) is not None:
                    cases.append((name, field, edit))
        fields = stream_fields(buf)
        if tagged:
            names = SETG_FIELDS if name.endswith("_setg") else APE_FIELDS[:-1]
        elif name == "multi16":
            names = MULTI_TRUNCATIONS
        else:
            names = HEADER_FIELDS + FRAME_FIELDS
        for field in names:
            for edit in ("at", "inside"):
                if edit == "inside" and name == "multi16":
                    continue
                if field_truncation(buf, fields, field,
                                    edit == "inside") is not None:
                    cases.append((name, field, f"truncate_{edit}"))
    return cases


def field_case(clips: dict, case: tuple[str, str, str]) -> bytes:
    name, field, edit = case
    buf = clips[name]
    if edit.startswith("truncate_"):
        return field_truncation(buf, stream_fields(buf), field,
                                edit == "truncate_inside")
    return field_edit(buf, field, edit)


def oracle_frames(buf: bytes) -> tuple[list, bool]:
    """The oracle's walk of buf as its decode_sela takes it: each frame it
    decodes before it accepts or refuses the stream, as ((start, end) bytes,
    PCM channels), and whether it accepts."""
    from sela_tpu_torch.errors import ContainerError
    from sela_tpu_torch.ref import container, frame

    walked = []
    try:
        h = container.parse_header(buf)
        pos = container.HEADER_SIZE
        for _ in range(h.num_frames):
            subframes, _, end = container.parse_frame(buf, pos, h.channels)
            walked.append(((pos, end), frame.decode_frame(subframes,
                                                          h.channels)))
            pos = end
        container.parse_trailer(buf, pos)
    except ContainerError:
        return walked, False
    return walked, True


@functools.lru_cache(maxsize=16)
def base_frames(base: bytes) -> tuple[list, bool]:
    """oracle_frames of a base clip, walked once a process."""
    return oracle_frames(base)


def prefix_reference(buf: bytes, base: bytes) -> list | None:
    """What decode_stream(buf, 1) must yield before it raises, where the
    oracle refuses buf (None where it accepts): the oracle's frames before
    the one it refuses, each as an [n, C] int32 block; a frame whose bytes
    are the base clip's frame's as that frame's oracle PCM, a changed frame
    as the oracle's PCM of it, or None where its reconstruction leaves
    int32 (the split that test_torch_hostile.py pins)."""
    from sela_tpu_torch.ref import container

    walked, accepted = oracle_frames(buf)
    if accepted:
        return None
    base_walked, _ = base_frames(base)
    want = []
    for f, ((s, e), pcm) in enumerate(walked):
        if f < len(base_walked) and buf[s:e] == base[slice(
                *base_walked[f][0])]:
            pcm = base_walked[f][1]
        else:   # the frame alone, as a stream of one frame
            h = container.parse_header(buf)
            h.num_frames = 1
            if leaves_int32(container.serialize_file(h, [buf[s:e]])):
                want.append(None)
                continue
        want.append(np.stack(pcm, axis=1).astype(np.int32))
    return want


def stream_blocks(buf: bytes, device: str, chunk: int) -> tuple:
    """decode_stream(buf, chunk) on `device`, block by block: the blocks it
    yielded, and what it raised (None where it ran to its end)."""
    from sela_tpu_torch.codec import stream

    blocks = []
    try:
        for block in stream.decode_stream(buf, chunk, device=device):
            blocks.append(block)
    except Exception as e:   # the stream-prefix property judges it
        return blocks, e
    return blocks, None


def stream_prefix_fault(want: list, blocks: list, error) -> str | None:
    """The stream-prefix property of a stream the oracle refuses: `blocks`
    and `error`, what decode_stream(buf, 1) yielded and raised, against
    prefix_reference's `want`. Returns what is wrong, or None."""
    from sela_tpu_torch.errors import ContainerError

    if not isinstance(error, ContainerError):
        return f"raised {error!r}, not the port's ContainerError"
    if len(blocks) != len(want):
        return (f"{len(blocks)} blocks before the error, where the oracle "
                f"decodes {len(want)} frames before it refuses")
    for f, (block, w) in enumerate(zip(blocks, want)):
        if w is not None and (block.dtype != np.int32
                              or not np.array_equal(block, w)):
            return f"block {f} differs from the oracle's PCM of its frame"
    return None


def group_partners(channels: int, wide: bool) -> tuple[bytes, bytes]:
    """Two valid files of decode_files' group (channels, > 24-bit), encoded
    by the port's oracle: 300 and 500 samples of noise, the first 16-bit
    and the second 24-bit in a <= 24-bit group, both 32-bit in the other."""
    from sela_tpu_torch.ref import codec as ref_codec
    from sela_tpu_torch.ref.wav import WavData

    rng = np.random.default_rng(17)
    out = []
    for n, bits in ((300, 32 if wide else 16), (500, 32 if wide else 24)):
        amp = 1 << (bits - 2)
        out.append(ref_codec.encode_wav(WavData(44100, bits, [
            rng.integers(-amp, amp, n).astype(np.int32)
            for _ in range(channels)])))
    return out[0], out[1]


def hostile_path(name: str, buf: bytes, device: str, chunk: int):
    """buf through one of the port's decode paths on `device`: its channels,
    or None where the path raised the port's ContainerError (any other
    exception propagates)."""
    from sela_tpu_torch.codec import corpus, decoder
    from sela_tpu_torch.errors import ContainerError

    if name == "decode_stream":
        return stream_channels(buf, *stream_blocks(buf, device, chunk))
    try:
        if name == "decode_sela":
            return decoder.decode_sela(buf, chunk, device=device).channels
        return corpus.decode_files([buf], chunk, device=device)[0].channels
    except ContainerError:
        return None


def stream_channels(buf: bytes, blocks: list, error):
    """stream_blocks' blocks as channels, None where decode_stream raised
    the port's ContainerError (anything else it raised is raised again)."""
    from sela_tpu_torch.errors import ContainerError
    from sela_tpu_torch.ref import container

    if isinstance(error, ContainerError):
        return None
    if error is not None:
        raise error
    C = container.parse_header(buf).channels
    pcm = np.concatenate(blocks) if blocks else np.zeros((0, C), np.int32)
    return [pcm[:, c] for c in range(C)]


def leaves_int32(buf: bytes) -> bool:
    """Whether the oracle's reconstruction of a stream it accepts leaves
    int32, where both packages split from it: an IIR sample (the oracle
    carries it in its int64 history, the port wraps it to 32 bits, K7's
    contract), or the rounding step side + (side & 1) of a side sample
    (int64 in the oracle, int32 in the port)."""
    from sela_tpu_torch.format import REF_Q, RICE_PARTITION_MARKER, SF_MID
    from sela_tpu_torch.ref import container, lpc, rice

    lo, hi, half = -(1 << 31), (1 << 31) - 1, 1 << (REF_Q - 1)
    h = container.parse_header(buf)
    pos = container.HEADER_SIZE
    for _ in range(h.num_frames):
        subframes, _, pos = container.parse_frame(buf, pos, h.channels)
        mids = {sf.channel for sf in subframes if sf.sftype == SF_MID}
        for sf in subframes:
            if sf.k_res == RICE_PARTITION_MARKER:
                e = rice.decode_partitioned(sf.res_words, sf.n_samples,
                                            sf.k_res_sub)
            else:
                e = rice.decode(sf.res_words, sf.n_samples, sf.k_res)
            x = e.astype(np.int64)
            if sf.order:
                q = rice.decode(sf.coeff_words, sf.order, sf.k_coeff)
                c = lpc.reflection_to_lpc(
                    lpc.dequantize_reflection(q)).astype(np.int64)
                hist = np.zeros(len(c), np.int64)
                for i in range(len(x)):
                    x[i] += (int(np.dot(c, hist)) + half) >> REF_Q
                    if not lo <= x[i] <= hi:
                        return True
                    hist[1:] = hist[:-1]
                    hist[0] = x[i]
            if sf.channel - 1 in mids and np.any(x == hi):
                return True
    return False


def hostile_reference(buf: bytes, base: bytes) -> tuple:
    """A pool worker's share of one buffer: the oracle's channels (None
    where it refuses the buffer), whether its reconstruction leaves int32,
    the three paths on the CPU, and where the oracle refuses it, what
    decode_stream(buf, 1) must yield before it raises (prefix_reference,
    against the clip `base` it was mutated from)."""
    import torch

    torch.set_num_threads(1)
    from sela_tpu_torch.errors import ContainerError
    from sela_tpu_torch.ref import codec as ref_codec

    try:
        oracle = ref_codec.decode_sela(buf).channels
    except ContainerError:
        oracle = None
    leaves = oracle is not None and leaves_int32(buf)
    prefix = None if oracle is not None else prefix_reference(buf, base)
    return oracle, leaves, {p: hostile_path(p, buf, "cpu", HOSTILE_CHUNK_CPU)
                            for p in HOSTILE_PATHS}, prefix


def card_group(corpus, container, base: bytes, buf: bytes,
               partners: dict) -> tuple:
    """decode_files([A, buf, B], GROUP_CHUNK) on the card, with A and B the
    group_partners of the base clip's group: the three files' channels
    (None where it raised the port's ContainerError), the decode_step calls
    it made, and A's and B's one-file decodes on the card."""
    from sela_tpu_torch.errors import ContainerError

    h = container.parse_header(base)
    key = (h.channels, h.bits_per_sample > 24)
    if key not in partners:
        a, b = group_partners(*key)
        partners[key] = a, b, [corpus.decode_files(
            [x], GROUP_CHUNK, device="cuda")[0].channels for x in (a, b)]
    a, b, alone = partners[key]
    real_step, steps = corpus.decode_step, []

    def decode_step(*args, **kwargs):
        steps.append(1)
        return real_step(*args, **kwargs)

    corpus.decode_step = decode_step
    try:
        files = [w.channels for w in corpus.decode_files(
            [a, buf, b], GROUP_CHUNK, device="cuda")]
    except ContainerError:
        files = None
    finally:
        corpus.decode_step = real_step
    return files, len(steps), alone


def field_corpus(clips: dict) -> list[tuple[str, str, bytes]]:
    """Phase 14's structure-aware streams, as (clip, field, stream): the
    multi-frame and tagged clips unmutated (field "none"), every
    deterministic mutation of field_cases(clips, every_clip=True), then
    FIELD_FLIPS seeded aimed flips of each field of each clip."""
    rng = np.random.default_rng(FIELD_SEED)
    out = [(name, "none", buf) for name, buf in clips.items()
           if name == "multi16" or name.endswith(("_setg", "_apev2"))]
    out += [(case[0], case[1], field_case(clips, case))
            for case in field_cases(clips, every_clip=True)]
    for name, buf in clips.items():
        fields = stream_fields(buf)
        names = (SETG_FIELDS if name.endswith("_setg") else APE_FIELDS
                 if name.endswith("_apev2") else HEADER_FIELDS + FRAME_FIELDS)
        for field in names:
            for _ in range(FIELD_FLIPS if field in fields else 0):
                out.append((name, field, aimed_flip(
                    buf, fields, field, lambda n: int(rng.integers(n)))))
    return out


def same_channels(a, b) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))


def phase_hostile(decoder, stream, corpus, container, k_lpc, k_iir) -> None:
    """Phase 14: the card's three decode paths against their CPU versions and
    the oracle on a seeded corpus of mutated streams: random byte flips and
    the structure-aware mutations; on each stream the oracle refuses, the
    stream prefix of decode_stream on the card; on the structure-aware
    streams, decode_files of the stream between two valid files of its
    group on the card."""
    import collections
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    log("== phase 14: hostile streams, the card's decode paths against their "
        "CPU versions and the oracle")
    t_phase = time.perf_counter()
    clips = hostile_clips()
    fclips = field_clips(clips)
    bases = {**clips, **fclips}
    entries = [(name, "none" if i < len(clips) else "xor", buf)
               for i, (name, buf) in enumerate(hostile_corpus(clips))]
    n_xor = len(entries)
    entries += field_corpus(fclips)
    pool = ProcessPoolExecutor(HOSTILE_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    with pool:   # the CPU side in worker processes while the card runs
        refs = [pool.submit(hostile_reference, buf, bases[name])
                for name, _, buf in entries]
        # the residue wire each path took: unpack's fits16, recorded per path
        real_unpack, fits = decoder.unpack, []

        def unpack(*args):
            out = real_unpack(*args)
            fits.append(out[3])
            return out

        mods = (decoder, stream, corpus)
        for mod in mods:
            mod.unpack = unpack
        k_lpc.launches = k_iir.launches = 0
        card, wire32, partners = [], dict.fromkeys(HOSTILE_PATHS, 0), {}
        try:
            for i, (name, field, buf) in enumerate(entries):
                got = {}
                for p in HOSTILE_PATHS:
                    fits.clear()
                    if p == "decode_stream":   # its blocks kept for the prefix
                        got["prefix"] = stream_blocks(buf, "cuda",
                                                      HOSTILE_CHUNK_CUDA)
                        got[p] = stream_channels(buf, *got["prefix"])
                    else:
                        got[p] = hostile_path(p, buf, "cuda",
                                              HOSTILE_CHUNK_CUDA)
                    wire32[p] += got[p] is not None and not all(fits)
                if i >= n_xor:
                    got["group"] = card_group(corpus, container, bases[name],
                                              buf, partners)
                card.append(got)
        finally:
            for mod in mods:
                mod.unpack = real_unpack
        launches = {"lpc": k_lpc.launches, "iir": k_iir.launches}
        t_card = time.perf_counter() - t_phase
        refs = [r.result() for r in refs]

    accepted = dict.fromkeys(HOSTILE_PATHS, 0)
    oracle_accepts, split = 0, {}
    refused, prefix_blocks = collections.Counter(), 0
    for (name, field, buf), got, (oracle, leaves, cpu, prefix) in zip(
            entries, card, refs):
        what = f"hostile {name} ({field})"
        oracle_accepts += oracle is not None
        if leaves:
            split[name] = split.get(name, 0) + 1
        elif oracle is not None:   # the oracle's samples, as each path has them
            want = dict.fromkeys(HOSTILE_PATHS, oracle)
            if container.parse_header(buf).bits_per_sample <= 16:
                want["decode_sela"] = [
                    c.astype(np.int16).astype(np.int32) for c in oracle]
        for p in HOSTILE_PATHS:
            verdicts = (got[p] is None, cpu[p] is None, oracle is None)
            check(len(set(verdicts)) == 1,
                  f"{what}: {p} refused on the card / on the CPU / by the "
                  f"oracle: {verdicts}")
            if got[p] is not None:
                accepted[p] += 1
                check(same_channels(got[p], cpu[p]),
                      f"{what}: {p}'s PCM on the card differs from its PCM "
                      f"on the CPU")
                check(leaves or same_channels(got[p], want[p]),
                      f"{what}: {p}'s PCM on the card differs from the "
                      f"oracle's")
        if oracle is None:
            refused[field] += 1
            prefix_blocks += len(got["prefix"][0])
            fault = stream_prefix_fault(prefix, *got["prefix"])
            check(fault is None, f"{what}: decode_stream's prefix on the "
                  f"card: {fault}")
        if "group" in got:
            files, steps, alone = got["group"]
            check((files is None) == (oracle is None),
                  f"{what}: decode_files of the group on the card refused "
                  f"{files is None}, the oracle {oracle is None}")
            check(files is not None or steps == 0,
                  f"{what}: {steps} device steps before the group's refusal")
            check(files is None or (
                same_channels(files[0], alone[0])
                and same_channels(files[1], got["decode_files"])
                and same_channels(files[2], alone[1])),
                f"{what}: a file of the group differs from its one-file "
                f"decode on the card")
    check(launches["lpc"] > 0 and launches["iir"] > 0,
          f"hostile streams: K1 or the IIR was not launched {launches}")
    i_wrap = list(clips).index("wrap16")
    wrap, want = card[i_wrap], refs[i_wrap][0][0]
    check(not refs[i_wrap][1], "the wrapping stream leaves int32")
    rng_ok = (int(want.min()), int(want.max())) == WRAP_RANGE
    for p in ("decode_stream", "decode_files"):
        check(rng_ok and wrap[p] is not None
              and same_channels(wrap[p], [want]),
              f"the wrapping stream: {p} on the card does not give the "
              f"oracle's int32 samples {WRAP_RANGE}")
    narrowed = want.astype(np.int16).astype(np.int32)
    check(same_channels(wrap["decode_sela"], [narrowed]),
          "the wrapping stream: decode_sela on the card does not narrow to "
          "int16 as both packages do")
    secs = time.perf_counter() - t_phase
    n_field = len(entries) - n_xor
    n_cases = len(field_cases(fclips, every_clip=True))
    n_new = len(fclips) - 5   # the clips hostile_clips lacks, unmutated
    log(f"{len(entries)} streams: {n_xor} of byte flips ({len(clips)} "
        f"unmutated, {HOSTILE_MUTATIONS} mutations of each of the 5 base "
        f"clips) and {n_field} structure-aware on {len(fclips)} clips "
        f"({n_new} unmutated, {n_cases} field edits and truncations, "
        f"{n_field - n_new - n_cases} aimed flips); "
        f"oracle accepts {oracle_accepts}, refuses "
        f"{len(entries) - oracle_accepts}; accepted on the card and on the "
        f"CPU: " + ", ".join(f"{p} {accepted[p]}" for p in HOSTILE_PATHS)
        + "; with the int32 residue wire (fits16 false): "
        + ", ".join(f"{p} {wire32[p]}" for p in HOSTILE_PATHS)
        + f"; equal to the oracle's samples but {sum(split.values())} whose "
        f"reconstruction leaves int32 {split}; "
        f"launches {launches}; the wrapping stream on the card: "
        f"decode_stream and decode_files {WRAP_RANGE[0]}..{WRAP_RANGE[1]} as "
        f"the oracle, decode_sela {int(np.count_nonzero(narrowed != want))} "
        f"samples narrowed as both packages narrow them; card side "
        f"{t_card:.1f} s, phase {secs:.1f} s")
    log(f"stream prefix on the card: {sum(refused.values())} refused "
        f"streams, {prefix_blocks} blocks yielded before the refusals, each "
        f"the oracle's; group damage on the card: {n_field} streams between "
        f"two valid files, each refusal before any device step; refused by "
        f"field: " + json.dumps(dict(sorted(refused.items()))))


# ------------------------------------------------------------ encode sweep --
# A seeded covering set of the encoder's input and profile space. Every
# depth, channel count, length, frame size, content and profile knob value
# below is in at least one case, and the pairs that one code path joins are
# together: 3 channels under est (one channel left unpaired), frame sizes
# that are no multiple of 4 under v2 (K3's and K5's scalar staging, K8's
# quarters), 32-bit stereo under the L/R rule, a 24-bit pair whose L - R
# needs 25 bits, 16-bit residues that leave int16 (the int32 fetch). A class
# is one (depths, channels, frame size, profile): one signature of the JAX
# encoder on the CPU. tests/test_torch_encode_sweep.py imports these
# functions, so the CPU tests and phase 15 sweep the same cases.

SWEEP_SEED = 17
SWEEP_CARD_SEEDS = 8      # phase 15: seeds SWEEP_SEED .. SWEEP_SEED + 7
SWEEP_TAIL = 517          # "3fs+": three frames and a tail
# (class, depths, channels, frame size, profile knobs besides frame_size ({}:
# the default profile), lengths ("fs" the frame size), contents)
SWEEP_CLASSES = (
    ("st16", (16, 8), 2, 2048, {},
     ("1", "31", "32", "33", "fs-1", "fs", "fs+1", "3fs+"),
     ("tone", "noise", "silence", "ramp", "square", "extremes", "identical",
      "one_silent", "identical_square", "square74")),
    ("mono16", (16, 8), 1, 2048, {"max_order": 1, "rice_k_max": 0},
     ("33", "fs", "3fs+"), ("ramp", "extremes", "chord", "tone")),
    ("lr", (32, 24), 2, 2047, {"residue_partition": 4},
     ("1", "fs-1", "fs", "fs+1", "3fs+"), ("spikes", "noise", "close_pair",
                                          "square", "extremes", "tone",
                                          "identical")),
    ("tri8", (8,), 3, 1000, {},
     ("31", "fs-1", "fs+1", "3fs+"), ("tone", "one_silent", "identical",
                                     "noise")),
    ("st24", (24,), 2, 1000, {},
     ("1", "33", "fs", "3fs+"), ("wide_side", "tone", "ramp", "noise")),
    ("six24", (24,), 6, 33, {},
     ("1", "32", "33", "fs+1", "3fs+"), ("tone", "identical", "wide_side",
                                        "extremes", "silence")),
    ("ex16", (16, 8), 2, 32, {"mid_side": "exact", "max_order": 8,
                              "rice_k_max": 7},
     ("1", "31", "32", "33", "3fs+"), ("tone", "identical_square",
                                       "wide_side", "square", "noise")),
)
# knobs of one depth of a class on top of the class's: 24-bit "lr" cases
# are mid_side "off", which runs 32-bit stereo's path (the L/R rule's) on
# <= 24-bit PCM, in the same JAX signature
SWEEP_DEPTH_KNOBS = {("lr", 24): {"mid_side": "off"}}
# contents whose bits and length are their point: a full-scale square wave
# of period 74 at 16 bits, whose residues leave int16 in every frame, and
# 32-bit spikes in a tone, whose residues pass the FIR guard's 2^30
SWEEP_FIXED = {"square74": (16, 4500), "spikes": (32, 4500)}
SWEEP_RATES = (44100, 48000, 96000, 22050, 8000)


def sweep_length(spec: str, fs: int) -> int:
    if spec == "3fs+":
        return 3 * fs + SWEEP_TAIL % fs
    if spec.startswith("fs"):
        return fs + int(spec[2:] or 0)
    return int(spec)


def sweep_content(kind: str, n: int, C: int, bits: int, rng) -> list:
    """C channels of n samples of `kind` at `bits`, full scale where the
    kind says so, as int32 arrays."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    t = np.arange(n)

    def tone(c):
        x = 0.6 * hi * np.sin(2 * np.pi * (0.011 + 0.007 * c) * t + c)
        return x + rng.normal(0, 1e-3 * hi + 1, n)

    def square(period):
        return np.where((t // (period // 2)) % 2 == 0, hi, lo)

    if kind == "noise":
        chans = [rng.integers(lo, hi + 1, n) for _ in range(C)]
    elif kind == "tone":
        chans = [tone(c) for c in range(C)]
    elif kind == "chord":   # five partials: LPC orders well past 8
        chans = [sum(0.12 * hi * np.sin(2 * np.pi * f * t + c)
                     for f in (0.013, 0.029, 0.047, 0.071, 0.11))
                 + rng.normal(0, 1e-3 * hi + 1, n) for c in range(C)]
    elif kind == "silence":
        chans = [np.zeros(n) for _ in range(C)]
    elif kind == "ramp":   # MIN to MAX over the clip, then sawtooths
        chans = [lo + (t * (hi - lo)) // max(n - 1, 1)] + [
            lo + (t * (hi - lo) // (90 + 37 * c)) % (hi - lo + 1)
            for c in range(1, C)]
    elif kind == "square":
        chans = [square(8 + 10 * c) for c in range(C)]
    elif kind == "extremes":
        chans = [rng.choice(np.array([lo, 0, hi]), n) for _ in range(C)]
    elif kind == "identical":
        chans = [tone(0)] * C
    elif kind == "identical_square":
        chans = [square(16)] * C
    elif kind == "one_silent":
        chans = [tone(c) for c in range(C - 1)] + [np.zeros(n)]
    elif kind == "wide_side":   # L - R needs bits + 1: (MAX, MIN), (MIN, MAX)
        half = t < n // 2
        chans = [np.where(half, hi, lo), np.where(half, lo, hi)] + [
            tone(c) for c in range(2, C)]
    elif kind == "square74":
        chans = [square(74)] * C
    elif kind == "spikes":   # MIN and MAX in a tone: residues past 2^30
        chans = [tone(c) for c in range(C)]
        for c, x in enumerate(chans):
            x[97 + c::301], x[248 + c::301] = hi, lo
    elif kind == "close_pair":   # R = L + a little noise: mid/side pays
        left = tone(0)
        chans = [left, left + rng.normal(0, 4, n)] + [
            tone(c) for c in range(2, C)]
    else:
        raise ValueError(kind)
    return [np.clip(np.round(x), lo, hi).astype(np.int32)[:n] for x in chans]


def sweep_cases(seed: int = SWEEP_SEED) -> list[dict]:
    """Every class's cases for one seed: as many as its lengths or its
    contents, whichever are more, each length and each content at least
    once, the depths in turn. SWEEP_SEED takes them in the tables' order;
    other seeds shuffle the lengths, contents and depths of each class.
    A case: name, klass, seed, rate, bits, chans, frame_size, profile (the
    knobs besides frame_size; {} is the default profile) and content."""
    rng = np.random.default_rng(seed)
    out = []
    for klass, depths, C, fs, knobs, lengths, contents in SWEEP_CLASSES:
        lens = [sweep_length(s, fs) for s in lengths]
        kinds, depths = list(contents), list(depths)
        if seed != SWEEP_SEED:
            rng.shuffle(lens)
            rng.shuffle(kinds)
            rng.shuffle(depths)
        for i in range(max(len(lens), len(kinds))):
            kind = kinds[i % len(kinds)]
            bits, n = SWEEP_FIXED.get(kind, (depths[i % len(depths)],
                                             lens[i % len(lens)]))
            out.append(dict(
                name=f"{klass}-s{seed}-{i}-{kind}-{bits}b-n{n}", klass=klass,
                seed=seed, rate=SWEEP_RATES[(i + seed) % len(SWEEP_RATES)],
                bits=bits,
                chans=sweep_content(kind, n, C, bits, rng), frame_size=fs,
                profile={**knobs, **SWEEP_DEPTH_KNOBS.get((klass, bits), {})},
                content=kind))
    return out


def sweep_encode_args(case: dict, profile_cls) -> dict:
    """encode_wav's keywords for a case, with the BitstreamProfile class of
    the package that encodes it: the frame size alone for the default
    profile, else the profile."""
    if not case["profile"]:
        return {"frame_size": case["frame_size"]}
    return {"profile": profile_cls(frame_size=case["frame_size"],
                                   **case["profile"])}


def sweep_est_split(case: dict) -> bool:
    """The split both packages share and the oracle does not: under est
    (mid_side "auto", <= 24-bit), a frame where one of a pair's four
    candidate rows (L, R, mid, side) is silent and another is not. A silent
    row's modeled cost is 0 (its r0 is 0), while a row with signal costs
    less than 0, so the rule compares costs that differ by more than their
    per-row constant: identical channels (side silent) keep L/R, one silent
    channel takes mid/side."""
    if (case["bits"] > 24 or len(case["chans"]) < 2
            or case["profile"].get("mid_side", "auto") != "auto"):
        return False
    fs, chans = case["frame_size"], case["chans"]
    F = -(-len(chans[0]) // fs)
    for p in range(len(chans) // 2):
        left, right = (np.resize(np.concatenate(
            [c, np.zeros(F * fs - len(c), np.int32)]), (F, fs))
            for c in chans[2 * p: 2 * p + 2])
        mid = (left >> 1) + (right >> 1) + (left & right & 1)
        rows = np.stack([left, right, mid, left - right], 1)   # [F, 4, fs]
        silent = ~rows.any(axis=2)
        if (silent.any(axis=1) & ~silent.all(axis=1)).any():
            return True
    return False


def sweep_layout_fault(buf: bytes, case: dict) -> str | None:
    """What in buf's layout, as the port's copy of the oracle parses it,
    the case's profile does not allow (None: nothing): frame sizes, LPC
    orders over max_order, Rice ks over rice_k_max but the escape,
    partitions without v2, mid/side on 32-bit PCM or under "off"."""
    from sela_tpu_torch.format import (MAX_ORDER, RICE_K_ESCAPE, RICE_K_MAX,
                                       RICE_PARTITION_MARKER, SF_DIRECT)
    from sela_tpu_torch.ref import container

    knobs, fs, n = case["profile"], case["frame_size"], len(case["chans"][0])
    ks = set(range(knobs.get("rice_k_max", RICE_K_MAX) + 1)) | {RICE_K_ESCAPE}
    mid_side = case["bits"] <= 24 and knobs.get("mid_side") != "off"
    h = container.parse_header(buf)
    if h.num_frames != -(-n // fs):
        return f"{h.num_frames} frames"
    pos = container.HEADER_SIZE
    for f in range(h.num_frames):
        subframes, ns, pos = container.parse_frame(buf, pos, h.channels)
        if ns != min(fs, n - f * fs):
            return f"frame {f}: {ns} samples"
        for sf in subframes:
            part = sf.k_res == RICE_PARTITION_MARKER
            faults = {
                "order": sf.order > knobs.get("max_order", MAX_ORDER),
                "k_coeff": sf.k_coeff not in ks,
                "k_res": not part and sf.k_res not in ks,
                "partition": part and (
                    knobs.get("residue_partition") != 4
                    or not set(sf.k_res_sub) <= ks),
                "mid/side": not mid_side and sf.sftype != SF_DIRECT}
            for what, bad in faults.items():
                if bad:
                    return f"frame {f} channel {sf.channel}: {what}"
    return None


def sweep_class(case: dict) -> str:
    """A case's class for phase 15's lines: depth x channels x frame size x
    profile."""
    knobs = ",".join(f"{k}={v}" for k, v in sorted(case["profile"].items()))
    return (f"{case['bits']}b x {len(case['chans'])} ch x fs "
            f"{case['frame_size']} x {knobs or 'default'}")


def sweep_reference(case: dict) -> tuple[bytes, int]:
    """The CPU side of a phase-15 case, in a worker process: the port's
    encode_wav stream on the CPU and the size of the oracle's stream."""
    from sela_tpu_torch.codec import encoder
    from sela_tpu_torch.config import BitstreamProfile
    from sela_tpu_torch.ref import codec as ref_codec
    from sela_tpu_torch.ref.wav import WavData

    w = WavData(case["rate"], case["bits"], case["chans"])
    kw = sweep_encode_args(case, BitstreamProfile)
    return (encoder.encode_wav(w, device="cpu", **kw),
            len(ref_codec.encode_wav(w, **kw)))


def sweep_oracle_exact(buf: bytes, case: dict) -> bool:
    """Does the port's oracle copy decode buf to the case's input, its
    depth, rate and channel count, and does buf keep the case's profile
    (sweep_layout_fault)? (a worker process)"""
    from sela_tpu_torch.ref import codec as ref_codec

    out = ref_codec.decode_sela(buf)
    return ((out.sample_rate, out.bits_per_sample)
            == (case["rate"], case["bits"])
            and same_channels(out.channels, case["chans"])
            and sweep_layout_fault(buf, case) is None)


SWEEP_SHARDS = 3          # ranks of the shard encode of P4's two cases
SWEEP_FILES_CHUNK = 2     # encode_files' chunk: groups share chunks


def phase_sweep(encoder, decoder, corpus, multihost, WavData, Metrics,
                BitstreamProfile, k_lpc, k_iir, k_enc, k_pack) -> dict:
    """Phase 15: the encoder's input and profile space on the card,
    SWEEP_CARD_SEEDS seeds of the sweep generator, against the CPU and the
    oracle."""
    import collections
    import hashlib
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    log("== phase 15: the encode sweep on the card against the CPU and the "
        "oracle")
    t_phase = time.perf_counter()
    cases = [c for s in range(SWEEP_SEED, SWEEP_SEED + SWEEP_CARD_SEEDS)
             for c in sweep_cases(s)]
    pool = ProcessPoolExecutor(HOSTILE_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    card, exact, fetched, host_blocks = {}, {}, {}, {}
    totals = collections.Counter()
    with pool:   # the CPU side in worker processes while the card runs
        refs = {c["name"]: pool.submit(sweep_reference, c) for c in cases}
        for case in cases:
            name, v2 = case["name"], "residue_partition" in case["profile"]
            w = WavData(case["rate"], case["bits"], case["chans"])
            m = Metrics()
            reset_launches(k_lpc, k_iir, k_enc)
            k_pack.launches = 0
            buf = encoder.encode_wav(w, device="cuda", metrics=m,
                                     **sweep_encode_args(case,
                                                         BitstreamProfile))
            launches = {"lpc": k_lpc.launches, **k_enc.launches,
                        "pack": k_pack.launches}
            totals.update(launches)
            # v1 packs on the card, two launches a chunk (K6 launches once
            # a chunk); v2 on the host
            check(all(launches[k] > 0 for k in ENCODE_KERNELS)
                  and (launches["quarter_counts"] > 0) == v2
                  and launches["pack"] == (0 if v2 else 2 * launches["ksel"]),
                  f"{name}: the encode kernels launched {launches}")
            host_blocks[name] = m.counters.get("pack_blocks_host", 0)
            out = decoder.decode_sela(buf, device="cuda")
            check((out.sample_rate, out.bits_per_sample)
                  == (case["rate"], case["bits"])
                  and same_channels([c.astype(np.int32) for c in
                                     out.channels], case["chans"]),
                  f"{name}: the card's stream does not decode to the input "
                  f"through the port's decode_sela on the card")
            card[name] = buf
            fetched[name] = m.counters.get("int32_fetch", 0)
            exact[name] = pool.submit(sweep_oracle_exact, buf, case)
        t_wav = time.perf_counter() - t_phase

        # P4: encode_files of each seed's default-profile cases of a frame
        # size in one call; the shard encode of its 4-frame 1,000 ones
        groups = collections.defaultdict(list)
        for case in cases:
            if not case["profile"]:
                groups[case["seed"], case["frame_size"]].append(case)
        n_files = n_shards = 0
        with tempfile.TemporaryDirectory() as tmp:
            for (seed, fs), group in groups.items():
                bufs = corpus.encode_files(
                    [WavData(c["rate"], c["bits"], c["chans"])
                     for c in group], SWEEP_FILES_CHUNK, frame_size=fs,
                    device="cuda")
                for case, buf in zip(group, bufs):
                    check(buf == card[case["name"]],
                          f"{case['name']}: encode_files on the card differs "
                          f"from encode_wav")
                n_files += len(group)
                for case in group:
                    if fs != 1000 or len(case["chans"][0]) < 3 * fs:
                        continue
                    d = os.path.join(tmp, case["name"])
                    w = WavData(case["rate"], case["bits"], case["chans"])
                    for rank in range(SWEEP_SHARDS):
                        multihost.encode_shard(w, d, rank, SWEEP_SHARDS,
                                               frame_size=fs, device="cuda")
                    merged = os.path.join(d, "merged.sela")
                    multihost.merge_shards(d, SWEEP_SHARDS, merged)
                    with open(merged, "rb") as f:
                        sha = hashlib.sha256(f.read()).hexdigest()
                    check(sha == hashlib.sha256(card[case["name"]])
                          .hexdigest(), f"{case['name']}: the shard merge's "
                          f"sha256 is not encode_wav's")
                    n_shards += 1
        t_card = time.perf_counter() - t_phase
        refs = {k: r.result() for k, r in refs.items()}
        exact = {k: r.result() for k, r in exact.items()}

    by_class = collections.defaultdict(list)
    over_oracle = collections.Counter()
    worst = 0.0
    for case in cases:
        name = case["name"]
        cpu, oracle = refs[name]
        got = len(card[name])
        check(exact[name], f"{name}: the card's stream does not decode to "
              f"the input through the oracle, or breaks its profile")
        diff = abs(got - len(cpu)) / len(cpu)
        worst = max(worst, diff)
        check(diff <= 0.005, f"{name}: the card's stream is {got} bytes, the "
              f"CPU's {len(cpu)}: over 0.5% apart")
        if got > 1.01 * oracle + 64:
            over_oracle["est split" if sweep_est_split(case) else
                        case["klass"]] += 1
        by_class[sweep_class(case)].append(
            (got, len(cpu), oracle, got == len(cpu) and card[name] == cpu,
             fetched[name], host_blocks[name]))
    int32_cases = [c["name"] for c in cases if fetched[c["name"]]]
    # v1 fetches residues only for blocks the host packs (escapes), which
    # rice_k_max 0 forces and 16-bit residues at rice_k_max 30 never need
    check(any(fetched[c["name"]] for c in cases
              if c["profile"].get("rice_k_max") == 0),
          "no rice_k_max=0 case fetched its residues for its escape blocks")
    check(not any(fetched[c["name"]] for c in cases
                  if c["content"] == "square74"),
          "a square74 case fetched its residues on the v1 path")
    for klass, rows in sorted(by_class.items()):
        log(f"  {klass}: {len(rows)} cases, card/CPU bytes "
            f"{sum(r[0] for r in rows)}/{sum(r[1] for r in rows)}, "
            f"{sum(r[3] for r in rows)} byte-identical to the CPU's, "
            f"card/oracle {sum(r[0] for r in rows) / sum(r[2] for r in rows):.4f}, "
            f"int32 fetches {sum(r[4] for r in rows)}, blocks packed on the "
            f"host {sum(r[5] for r in rows)}")
    secs = time.perf_counter() - t_phase
    log(f"{len(cases)} cases ({SWEEP_CARD_SEEDS} seeds of {len(by_class)} "
        f"classes): each decodes to the input through the oracle and the "
        f"card's decode_sela and keeps its profile; card within {worst:.5f} of the CPU's size "
        f"(gate 0.005); encode_files gives encode_wav's bytes on {n_files} "
        f"files, the shard merge its sha256 on {n_shards} over "
        f"{SWEEP_SHARDS} ranks; launches {dict(totals)}; int32 residue "
        f"fetches {sum(fetched.values())} chunks in {len(int32_cases)} cases; "
        f"over 1.01x the oracle + 64 bytes (a reading): {dict(over_oracle)}; "
        f"encode_wav {t_wav:.1f} s, card side {t_card:.1f} s, phase "
        f"{secs:.1f} s")
    return dict(cases=len(cases), int32_fetch=sum(fetched.values()),
                launches=dict(totals), seconds=secs)


def main(argv: list[str]) -> int:
    import torch

    if argv not in ([], ["--encode-profile"], ["--encode-sweep"]):
        fail(f"usage: python3 chip_smoke.py [--encode-profile | "
             f"--encode-sweep], got {argv}")

    kind, smi = phase_device(torch)
    sys.path.insert(0, HERE)
    import sela_tpu_torch

    pkg = os.path.dirname(os.path.abspath(sela_tpu_torch.__file__))
    check(pkg == os.path.join(HERE, "sela_tpu_torch"),
          f"sela_tpu_torch imported from {pkg}, not from this checkout")
    from sela_tpu_torch import bench
    from sela_tpu_torch.codec import corpus, decoder, encoder, pipeline, stream
    from sela_tpu_torch.config import BitstreamProfile
    from sela_tpu_torch.kernels import chain as k_chain
    from sela_tpu_torch.kernels import coeffs as k_lpc
    from sela_tpu_torch.kernels import encode as k_enc
    from sela_tpu_torch.kernels import iir as k_iir
    from sela_tpu_torch.kernels import pack as k_pack
    from sela_tpu_torch.native import bitio
    from sela_tpu_torch.ops import analysis as ops_analysis
    from sela_tpu_torch.ops import coeffs as ops_coeffs
    from sela_tpu_torch.ops import filters
    from sela_tpu_torch.ops import pack as ops_pack
    from sela_tpu_torch.ops import rice as ops_rice
    from sela_tpu_torch.parallel import multihost
    from sela_tpu_torch.ref import codec as ref_codec
    from sela_tpu_torch.ref import container
    from sela_tpu_torch.ref import lpc as ref_lpc
    from sela_tpu_torch.ref.wav import WavData
    from sela_tpu_torch.utils.build import BUILD_DIR, build_log, nvcc
    from sela_tpu_torch.utils.metrics import Metrics

    phase_build(k_lpc, k_iir, k_enc, k_pack, k_chain, bitio, build_log,
                BUILD_DIR, nvcc)
    enc_args = (torch, encoder, decoder, ref_codec, WavData, Metrics, bitio,
                container, k_lpc, k_iir, k_enc, k_pack)
    v2 = BitstreamProfile(residue_partition=4)
    sweep_args = (encoder, decoder, corpus, multihost, WavData, Metrics,
                  BitstreamProfile, k_lpc, k_iir, k_enc, k_pack)
    if argv == ["--encode-sweep"]:   # phase 15 alone
        phase_sweep(*sweep_args)
        return 0
    if argv:   # --encode-profile: the profiled encodes alone
        log("== the profiled encodes alone: cd_180s v1 and v2, perc_20s v2")
        cd = make_track(180.0, 44100, 16, seed=0)
        perc = make_percussive(20.0, seed=3)
        for name, chans, prof in (("cd_180s", cd, None), ("cd_180s", cd, v2),
                                  ("perc_20s", perc, v2)):
            phase_encode(*enc_args, name, chans, 44100, 16, profile=prof,
                         warm=True)
        return 0
    lpc = phase_lpc(torch, ops_coeffs)

    t0 = time.perf_counter()
    cd = make_track(180.0, 44100, 16, seed=0)
    log(f"(3-minute track made in {time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(2)
    rows = oracle_rows(ref_lpc, cd, ROWS_MAIN, rng)
    iir = phase_iir(torch, ops_coeffs, filters, k_iir, rows, rng)
    k5, k6, plan, render = phase_fir_ksel(torch, ops_coeffs, filters,
                                          ops_rice, rows, rng)
    k8, k6v2, plan_v2 = phase_quarter_counts(torch, ops_rice, render, rng)
    k3, k4 = phase_analysis(torch, ops_analysis, pipeline, cd)

    clips = [("cd_180s", cd, 44100, 16),
             ("hires_30s", make_track(30.0, 96000, 24, seed=1), 96000, 24)]
    c32 = make_track(10.0, 48000, 32, seed=2)
    c32[0][1000], c32[0][5000], c32[1][77_777] = -(1 << 31), (1 << 31) - 1, -(1 << 31)
    clips.append(("int32_10s", c32, 48000, 32))

    log("== phase 7: decode end to end")
    k_pack.launches = 0   # the packer is on no decode path
    e2e_args = (torch, decoder, ref_codec, WavData, Metrics, bitio, container,
                k_lpc, k_iir)
    decoded = {name: phase_e2e(*e2e_args, name, chans, rate, bits,
                               warm=name == "cd_180s")
               for name, chans, rate, bits in clips}
    log(f"packer launches in phase 7 (decode_sela): {k_pack.launches}")
    check(k_pack.launches == 0, "the packer ran on the decode path")

    log("== phase 8: encode end to end")
    encoded = {name: phase_encode(
        *enc_args, name, chans, rate, bits, decoded[name]["oracle_bytes"],
        max_vs_oracle=1.01 if name == "cd_180s" else None,
        oracle_decode=bits == 32, warm=name == "cd_180s")
        for name, chans, rate, bits in clips}
    dec_main, enc_main = decoded["cd_180s"], encoded["cd_180s"]

    log("== phase 9: encode end to end, partitioned residues (v2)")
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

    log("== phase 9b: the same encodes with the render's planning on its "
        "plain version (a check)")
    kernel_plan = pipeline.rice_plan
    pipeline.rice_plan = ops_rice.rice_plan_reference
    try:
        for label, chans, prof, ref in (("cd_180s (v1)", cd, None, enc_main),
                                        ("perc_20s (v2)", perc, v2, perc_v2)):
            k_enc.launches["ksel"] = 0
            buf = encoder.encode_wav(WavData(44100, 16, chans), device="cuda",
                                     profile=prof)
            same = buf == ref["stream"]
            log(f"{label}: stream with the plain planning byte-identical to "
                f"the kernel's: {same} ({len(buf)} bytes; K6 launches "
                f"{k_enc.launches['ksel']})")
            check(same and k_enc.launches["ksel"] == 0,
                  f"{label}: the plain planning gives another stream")
    finally:
        pipeline.rice_plan = kernel_plan

    pack = phase_pack(torch, pipeline, encoder, ops_pack, ops_rice, k_pack,
                      bitio, cd)
    paths = phase_slice(torch, bench, decoder, stream, WavData, k_lpc, k_iir,
                        k_enc, k_pack, cd, dec_main, enc_main)
    par = phase_parallel(torch, encoder, decoder, WavData, Metrics, k_lpc,
                         k_iir, k_enc, cd, c32)
    sharded = par["sharded"]
    tools = phase_tools(torch, k_chain, k_lpc, k_iir, k_enc, BUILD_DIR, nvcc)
    k9 = tools["k9"]
    phase_hostile(decoder, stream, corpus, container, k_lpc, k_iir)
    phase_sweep(*sweep_args)

    log("== phase 16: summary")

    def entry(name, source, replaces, res, launches, library_ms=None,
              launches_by_path=None, **extra):
        # phase 12's launches: the sharded steps' (the packer is not on them)
        by_path = dict(launches_by_path or {})
        if name in SHARDED_NAMES:
            by_path["sharded"] = sharded[SHARDED_NAMES[name]]
        return dict(name=name, route="cuda", source=f"sela_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches, **res,
                    share=share(res["bound_ms"], res["ms"]),
                    library_ms=library_ms, launches_by_path=by_path, **extra)

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
        entry("ksel", "ksel.cu", "sela_tpu/kernels/encode.py:474",
              {k: v for k, v in plan.items() if k != "rows"},
              enc_main["launches"]["ksel"], c_entry="sela_rice_plan (the render)",
              launches_by_path={"v1": enc_main["launches"]["ksel"],
                                "v2": enc_v2["launches"]["ksel"]},
              v2=plan_v2, generic=k6, generic_v2_shape=k6v2),
        entry("quarter_counts", "quarter_counts.cu",
              "sela_tpu/kernels/encode.py:401", k8,
              enc_v2["launches"]["quarter_counts"]),
        # v1 encode_wav packs on the card (sela_pack_at, 2 a chunk); the
        # bench's A/B runs sela_pack
        entry("pack_blocks", "pack.cu",
              "sela_tpu/ops/pack.py:44 (jnp, not a Pallas kernel)", pack,
              enc_main["launches"]["pack"],
              launches_by_path={"encode": enc_main["launches"]["pack"],
                                "encode_v2": enc_v2["launches"]["pack"],
                                "decode_sela": 0,
                                "bench_device_pack": paths[
                                    "device_pack_launches"]}),
        # the chain's path is the roofline tool (phase 13 (c))
        entry("int_chain", "int_chain.cu", "tools/roofline.py:79",
              {k: k9[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by")}, k9["launches"],
              launches_by_path={"roofline": k9["launches"]},
              shape=k9["shape"], steps=k9["steps"],
              sass_imads_a_loop=k9["sass_imads_a_loop"],
              readings=k9["roofline"]),
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
    sys.exit(main(sys.argv[1:]))
