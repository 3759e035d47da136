"""Frame-axis sharding of the codec steps over devices (frames are the
data-parallel axis).

Counterpart of sela_tpu/parallel/mesh.py. The JAX package pjit's its steps
over a 1-D ('data',) jax.sharding.Mesh; here one process drives every
device of a `DataMesh` itself (a single controller, as in JAX): the frame
axis is padded to a multiple of the mesh size and split into contiguous
equal shards, shard i is copied to `mesh.devices[i]` without blocking and
runs codec/pipeline.py's `encode_step` / `decode_step` there, and the
outputs are gathered in frame order onto `mesh.devices[0]` with the padding
trimmed. Every frame is planned, rendered and synthesized alone, so the
results do not depend on the sharding.

Nothing between two shards' launches waits on a device (no `.item()`,
`.cpu()` or `bool(...)` on a device tensor), so the cards of a multi-card
host run their shards at the same time. A device may be listed more than
once (`["cuda:0"] * 4`, or `["cpu"] * 8` in the CPU tests, as the JAX suite
runs 8 virtual CPU devices): its shards then run one after another on it.

Size: the kernels index rows in 64 bits and take up to 2^31 - 1 rows a
launch. A shard is run in steps of at most `MAX_STEP_ELEMENTS` candidate
samples (32,768 stereo frames of 2,048 samples, 1 GiB of int32 candidates)
one after another on its device, so a multi-hour file neither overflows a
32-bit count nor needs its whole working set on the card at once.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..codec.pipeline import (_render_rows, decode_step, encode_step,
                              make_candidates)
from ..format import RESIDUE_PARTS, RICE_K_MAX, SF_DIRECT
from ..utils.device import resolve_device

MAX_STEP_ELEMENTS = 1 << 28   # candidate samples (rows x S) of one device step


@dataclass(frozen=True)
class DataMesh:
    """A 1-D mesh: the devices that hold the frame shards, in frame order."""
    devices: tuple[torch.device, ...]
    axis: str = "data"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}


def data_mesh(n_devices: int | None = None, devices=None) -> DataMesh:
    """1-D mesh over `devices` (default: every CUDA device), the first
    `n_devices` of them if given. With no CUDA and no `devices` this raises;
    it never falls back to the CPU. A device may repeat (`["cpu"] * 8`,
    `["cuda:0"] * 4`): shards on one device run one after another on it."""
    if devices is None:
        first = resolve_device(None)   # raises without CUDA
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())] or [first]
    devices = tuple(resolve_device(d) for d in devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"n_devices {n_devices} outside [1, "
                             f"{len(devices)}]")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return DataMesh(devices)


def pad_frames_to_multiple(x: np.ndarray, n_valid: np.ndarray, multiple: int):
    """Pad the frame axis so it divides evenly across the mesh."""
    F = x.shape[0]
    pad = (-F) % multiple
    if pad:
        x = np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)], axis=0)
        n_valid = np.concatenate([n_valid, np.zeros(pad, n_valid.dtype)])
    return x, n_valid


def _shards(mesh: DataMesh, *arrays):
    """Split the frame axis of `arrays` (numpy arrays or tensors on any
    device) into mesh.size contiguous equal shards, the last ones padded
    with zero frames, each copied without blocking to its device. Yields
    (frames of the shard that are real, the shard's tensors)."""
    arrays = [torch.as_tensor(a) for a in arrays]
    F = arrays[0].shape[0]
    per = -(-F // mesh.size)
    for i, dev in enumerate(mesh.devices):
        lo, hi = min(i * per, F), min((i + 1) * per, F)
        parts = []
        for a in arrays:
            part = a[lo:hi].to(dev, non_blocking=True).contiguous()
            if hi - lo < per:
                part = torch.cat([part, part.new_zeros(
                    (per - (hi - lo), *a.shape[1:]))])
            parts.append(part)
        yield hi - lo, parts


def _tree(fn, *outs):
    """fn over the matching tensors of outputs of one structure (a tensor,
    a tuple of tensors or a dict of them)."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _tree(fn, *(o[k] for o in outs)) for k in first}
    if isinstance(first, tuple):
        return tuple(_tree(fn, *col) for col in zip(*outs))
    return fn(*outs)


def _steps(fn, parts, frames_per_step: int):
    """fn over frame slices of `parts` of at most frames_per_step frames,
    concatenated: the frames are independent, so this changes no result."""
    F = parts[0].shape[0]
    if F <= frames_per_step:
        return fn(*parts)
    outs = [fn(*(p[lo:lo + frames_per_step] for p in parts))
            for lo in range(0, F, frames_per_step)]
    return _tree(lambda *t: torch.cat(t), *outs)


def _run(mesh: DataMesh, fn, arrays, rows_a_frame: int):
    """fn on every shard, each in device steps of at most MAX_STEP_ELEMENTS
    samples over `rows_a_frame` rows a frame; then the outputs gathered in
    frame order onto mesh.devices[0], the padding frames dropped. Every
    shard is launched before any gather is queued."""
    S = max(arrays[0].shape[-1], 1)
    per_step = max(1, MAX_STEP_ELEMENTS // (rows_a_frame * S))
    real, outs = [], []
    for n, parts in _shards(mesh, *arrays):
        real.append(n)
        outs.append(_steps(fn, parts, per_step))
    dev0 = mesh.devices[0]
    return _tree(lambda *t: torch.cat([p[:n].to(dev0, non_blocking=True)
                                       for n, p in zip(real, t)]), *outs)


def _candidates(C: int, allow_ms: bool) -> int:
    return C + 2 * (C // 2) if allow_ms else C


def sharded_encode_step(mesh: DataMesh, **static):
    """encode_step over the mesh, frames sharded on 'data'.

    static: encode_step's knobs (allow_ms, max_order, rice_k_max,
    partition, ms_mode). The returned callable takes (x [F, C, S],
    n_valid [F]) as numpy arrays or tensors and returns encode_step's dict,
    every array on mesh.devices[0] in frame order."""
    def step(x, n_valid):
        C = x.shape[1]
        return _run(mesh, lambda xs, nv: encode_step(xs, nv, **static),
                    (x, n_valid), _candidates(C, static.get("allow_ms", True)))
    return step


def sharded_decode_step(mesh: DataMesh, out_dtype: torch.dtype = torch.int32):
    """decode_step over the mesh: (residues, qcoeffs, order, sftype) in
    decode_step's layouts -> PCM [F, C, S] of out_dtype on
    mesh.devices[0]."""
    def step(residues, qcoeffs, order, sftype):
        return _run(mesh, lambda r, q, o, t: decode_step(r, q, o, t,
                                                         out_dtype),
                    (residues, qcoeffs, order, sftype), residues.shape[1])
    return step


def _codec(x, n_valid, **static):
    """Encode then decode one shard: (PCM, exact [F] bool), exact where
    the PCM equals x up to n_valid."""
    enc = encode_step(x, n_valid, **static)
    pcm = decode_step(enc["residues"], enc["qcoeffs"], enc["order"],
                      enc["sftype"])
    S = x.shape[-1]
    valid = (torch.arange(S, device=x.device)[None, None, :]
             < n_valid[:, None, None])
    exact = torch.where(valid, pcm == x.to(torch.int32), True).all(dim=2)
    return pcm, exact.all(dim=1)


def sharded_codec_step(mesh: DataMesh, **static):
    """The full encode -> decode round trip over the mesh (the codec's
    'training step'), frames sharded on 'data'. The callable takes
    (x, n_valid) and returns (PCM [F, C, S] int32, exact [F] bool) on
    mesh.devices[0]: exact[f] is true when frame f's PCM equals x up to
    n_valid[f]."""
    def step(x, n_valid):
        C = x.shape[1]
        return _run(mesh, lambda xs, nv: _codec(xs, nv, **static),
                    (x, n_valid), _candidates(C, static.get("allow_ms", True)))
    return step


RENDER_CHECKS = {   # encode_step key -> _render_rows key
    "residues": "e", "order": "eff_order", "k_res": "k_res",
    "k_res4": "kr4", "k_coeff": "k_coeff", "nw_res": "nw_res",
    "nw_coeff": "nw_coeff",
}


def rerender(x, n_valid, enc: dict) -> dict:
    """The normative integer render, unsharded on enc's device, of the rows
    a partition=4 encode chose: each channel's direct or mid/side candidate
    by enc["sftype"], with enc's (qcoeffs, order). Returns encode_step's
    keys of RENDER_CHECKS as [F, C, ...] arrays."""
    dev = enc["order"].device
    x = torch.as_tensor(x).to(dev, torch.int32)
    n_valid = torch.as_tensor(n_valid).to(dev, torch.int32)
    F, C, S = x.shape
    cand = make_candidates(x)
    # channel c of a pair takes its mid/side row C + c where it chose one
    xw = torch.stack([
        torch.where((enc["sftype"][:, c] != SF_DIRECT)[:, None],
                    cand[:, C + c], x[:, c]) if c < 2 * (C // 2) else x[:, c]
        for c in range(C)], dim=1)
    r = _render_rows(xw.reshape(F * C, S),
                     enc["qcoeffs"].reshape(F * C, -1).contiguous(),
                     enc["order"].reshape(F * C).contiguous(),
                     n_valid.repeat_interleave(C), RICE_K_MAX,
                     partition=RESIDUE_PARTS)
    return {k: r[rk].reshape(F, C, *r[rk].shape[1:])
            for k, rk in RENDER_CHECKS.items()}


def dryrun_multichip(mesh: DataMesh, x, n_valid) -> dict:
    """One sharded encode (partition=4) and one sharded codec step on the
    mesh, with the JAX dry run's two assertions
    (__graft_entry__.py::dryrun_multichip):

    1. given the sharded encode's own planning (qcoeffs, order, sftype),
       the normative integer render recomputed unsharded reproduces its
       residues, order, k_res, k_res4, k_coeff, nw_res and nw_coeff
       element for element;
    2. the sharded encode -> decode round trip is bit-exact.

    x [F, C, S], n_valid [F] (numpy arrays or tensors). Raises
    AssertionError naming the first key that differs; returns the sharded
    encode's dict (on mesh.devices[0])."""
    enc = sharded_encode_step(mesh, partition=RESIDUE_PARTS)(x, n_valid)
    again = rerender(x, n_valid, enc)
    for key, want in again.items():
        if not torch.equal(enc[key], want):
            raise AssertionError(f"normative integer render is not "
                                 f"sharding-invariant: {key!r}")
    _, exact = sharded_codec_step(mesh)(x, n_valid)
    if not bool(exact.all()):
        raise AssertionError("sharded round trip not bit-exact")
    return enc

