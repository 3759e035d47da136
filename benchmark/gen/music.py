"""Synthetic stereo music, made on the device from a recipe and a seed.

The kind of music `chip_smoke.py::make_track` makes: notes of 0.5-2 s, each
a fundamental with vibrato and 1-10 harmonics under an attack/decay
envelope, plus AR noise of 0-16 resonances at a per-note level; the right
channel mixes the left's voice with a second one at a per-note weight, so
both mid/side and direct frames occur and the LPC orders spread from 0 to 32.

Two changes make it fit a benchmark's set-up and its bounds:

- Speed. The sines are computed in float64 on the device, and the notes'
  AR colour is applied in the frequency domain, all notes in one batch of
  one FFT length (each white noise's spectrum over A(e^jw)), which needs
  no sample-by-sample filter.
- Steadiness. A track's notes (lengths, pitches, harmonics, decays, levels,
  resonances, weights) come from the configuration's `recipe_seed`, so every
  run plays the same multiset of notes. The run's seed draws their order,
  the phases and every noise sample. So two seeds differ in their audio and
  hardly in its statistics, and the compressed size is steady from seed to
  seed. The level is fixed by the recipe, not by the track's own peak.
"""
from __future__ import annotations

import numpy as np
import torch


def recipe(seconds: float, rate: int, recipe_seed: int, track: int) -> dict:
    """A track's notes: a dict of per-note arrays, from the recipe seed."""
    rng = np.random.default_rng([recipe_seed, track])
    n = int(round(seconds * rate))
    lens = []
    while sum(lens) < n:
        lens.append(int(rng.uniform(0.5, 2.0) * rate))
    k = len(lens)
    lens = np.asarray(lens, np.float64)
    lens = np.floor(lens * (n / lens.sum())).astype(np.int64)
    lens[: n - int(lens.sum())] += 1        # the notes fill the track exactly
    n_res = rng.choice([0, 1, 2, 4, 8, 12, 16], k)
    bare = rng.random(k) < 0.1               # white noise alone
    notes = dict(
        lens=lens,
        f0=55.0 * 2 ** (rng.integers(0, 48, (2, k)) / 12),
        n_harm=rng.integers(1, 11, (2, k)),
        decay=rng.uniform(0.2, 3.0, (2, k)),
        gain=np.where(bare, 0.0, 10.0 ** rng.uniform(-2.0, 0.0, k)),
        level=10.0 ** rng.uniform(-3.5, -0.5, k),
        n_res=np.where(bare, 0, n_res),
        weight=rng.choice([0.0, 0.05, 0.4, 1.0], k),
    )
    # the resonances of each note's noise, left and right: poles near the
    # unit circle
    notes["poles"] = [[rng.uniform(0.95, 0.999, r) * np.exp(
        1j * rng.uniform(0.05, 3.0, r)) for r in notes["n_res"]]
        for _ in range(2)]
    return notes


def _voice(notes: dict, v: int, order: np.ndarray, t: torch.Tensor,
           t_note: torch.Tensor, idx: torch.Tensor, rate: int, phases,
           dev) -> torch.Tensor:
    f0 = torch.as_tensor(notes["f0"][v][order], device=dev)[idx]
    n_harm = torch.as_tensor(notes["n_harm"][v][order], device=dev)[idx]
    decay = torch.as_tensor(notes["decay"][v][order], device=dev)[idx]
    vib = 1.0 + 0.006 * torch.sin(2 * np.pi * 5.5 * t + float(phases[0]))
    phase = torch.cumsum(f0 * vib, 0) * (2 * np.pi / rate)
    out = torch.zeros_like(t)
    for h in range(1, 11):
        amp = (n_harm >= h).to(torch.float64) * 0.7 ** (h - 1)
        out += amp * torch.sin(h * phase + float(phases[h]))
    env = (1 - torch.exp(-t_note * 60.0)) * torch.exp(-t_note * decay)
    return out * env


def _noise(notes: dict, side: int, order: np.ndarray, bounds: np.ndarray,
           gen: torch.Generator, dev) -> torch.Tensor:
    """Each note's AR-coloured noise at its level: white noise of one FFT
    length a note, all notes' spectra divided by their A(e^jw) at once,
    each note's first samples kept."""
    lens = np.diff(bounds)
    k, n_fft = len(lens), 1 << int(max(lens) - 1).bit_length()
    white = torch.randn(k, n_fft, generator=gen, device=dev,
                        dtype=torch.float64)
    poles = np.zeros((k, 2 * max(max(notes["n_res"]), 1)), np.complex128)
    for j, note in enumerate(order):
        p = notes["poles"][side][note]
        poles[j, :2 * len(p)] = np.concatenate([p, p.conj()])
    w = torch.exp(-1j * torch.linspace(0, np.pi, n_fft // 2 + 1,
                                       dtype=torch.float64, device=dev))
    spec = torch.fft.rfft(white)
    for col in torch.as_tensor(poles, device=dev).T:   # 1 - p e^-jw a pole
        spec /= 1 - col[:, None] * w[None, :]
    seg = torch.fft.irfft(spec, n=n_fft)
    keep = (torch.arange(n_fft, device=dev)[None, :]
            < torch.as_tensor(lens, device=dev)[:, None])
    cnt = torch.as_tensor(lens, device=dev, dtype=torch.float64)
    mean = (seg * keep).sum(1) / cnt
    std = torch.sqrt((((seg - mean[:, None]) * keep) ** 2).sum(1)
                     / (cnt - 1).clamp_min(1)).clamp_min(1e-9)
    level = torch.as_tensor(notes["level"][order], device=dev)
    return (seg / std[:, None] * level[:, None])[keep]


def make_track(seconds: float, rate: int, bits: int, recipe_seed: int,
               track: int, seed: int, device) -> list[np.ndarray]:
    """One track of int32 channels (left, right) at `bits`: the recipe's
    notes in the order, phases and noise that `seed` draws."""
    dev = torch.device(device)
    notes = recipe(seconds, rate, recipe_seed, track)
    rng = np.random.default_rng([seed % (1 << 63), track])
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(0, 1 << 62)))
    k = len(notes["lens"])
    order = rng.permutation(k)
    lens = notes["lens"][order]
    bounds = np.concatenate([[0], np.cumsum(lens)])
    n = int(bounds[-1])
    idx = torch.repeat_interleave(torch.arange(k, device=dev),
                                  torch.as_tensor(lens, device=dev))
    t = torch.arange(n, device=dev, dtype=torch.float64) / rate
    t_note = t - torch.as_tensor(bounds[:-1] / rate, device=dev)[idx]
    music, other = (_voice(notes, v, order, t, t_note, idx, rate,
                           rng.uniform(0, 2 * np.pi, 11), dev)
                    for v in range(2))
    g = torch.as_tensor(notes["gain"][order], device=dev)[idx]
    w = torch.as_tensor(notes["weight"][order], device=dev)[idx]
    left = 0.35 * g * music + _noise(notes, 0, order, bounds, gen, dev)
    right = (0.35 * g * ((1 - w) * music + w * other)
             + _noise(notes, 1, order, bounds, gen, dev))
    # a level the recipe fixes: the loudest note's music and six standard
    # deviations of its noise at 0.8 of full scale
    harmonics = sum(0.7 ** h for h in range(10))
    peak = float(np.max(0.35 * notes["gain"] * harmonics + 6 * notes["level"]))
    full = (1 << (bits - 1)) - 1
    scale = 0.8 * full / peak
    return [torch.clamp(torch.round(x * scale), -full - 1, full)
            .to(torch.int32).cpu().numpy() for x in (left, right)]
