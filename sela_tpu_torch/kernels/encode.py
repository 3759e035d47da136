"""K3-K6 and K8 on the card: launchers of the five encode kernels.

One CUDA C++ source and library per kernel, each replacing one
sela_tpu/kernels/encode.py kernel:

    autocorr        csrc/autocorr.cu        K3 _autocorr_kernel
                                               (autocorr_pallas)
    levinson        csrc/levinson.cu        K4 _make_levinson_kernel
                                               (analyze_pallas)
    fir_rice        csrc/fir_rice.cu        K5 _fir_rice_kernel
                                               (fir_rice_pallas)
    ksel            csrc/ksel.cu            K6 _make_ksel_kernel (ksel_pallas);
                                               its second entry, rice_plan,
                                               is the render's Rice planning
    quarter_counts  csrc/quarter_counts.cu  K8 _quarter_counts_kernel
                                               (quarter_counts_pallas)

Each source says what bounds it and how it is laid out. The dispatching
wrappers with their checks, and the plain versions beside them, are
ops/analysis.py (autocorr, analyze_from_r), ops/filters.py (fir_rice) and
ops/rice.py (ksel, rice_plan, quarter_counts). The launchers here take checked,
contiguous tensors on one CUDA device, allocate the outputs, launch on the
current stream and count the launch.
"""
from __future__ import annotations

import ctypes
import os

import torch

from ..utils.build import build_cuda

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
_P = ctypes.c_void_p
_I = ctypes.c_int

# kernel -> (library, source, C entry point, argtypes without the stream,
#            extra nvcc flags)
KERNELS = {
    "autocorr": ("sela_autocorr", "autocorr.cu", "sela_autocorr",
                 [_P, _P, _I, _I], ()),
    # IEEE rounding, no flush to zero (nvcc's defaults, pinned): the kernel
    # must round as the plain PyTorch version does
    "levinson": ("sela_levinson", "levinson.cu", "sela_levinson",
                 [_P, _P, _P, _P, _P, _I, _I],
                 ("-ftz=false", "-prec-div=true", "-prec-sqrt=true")),
    "fir_rice": ("sela_fir_rice", "fir_rice.cu", "sela_fir_rice",
                 [_P, _P, _P, _P, _P, _P, _P, _I, _I], ()),
    "ksel": ("sela_ksel", "ksel.cu", "sela_ksel", [_P, _P, _P, _P, _I, _I], ()),
    "quarter_counts": ("sela_quarter_counts", "quarter_counts.cu",
                       "sela_quarter_counts", [_P, _P, _P, _I, _I], ()),
}
# further C entry points of a kernel's library: symbol -> (kernel, argtypes
# without the stream); a launch through one counts as a launch of the kernel
ENTRIES = {"sela_rice_plan": ("ksel", [_P, _P, _P, _P, _P, _P, _P, _I, _I])}
launches = {name: 0 for name in KERNELS}   # since the last reset (chip_smoke.py)
_libs: dict[str, ctypes.CDLL] = {}


def load(kernel: str) -> ctypes.CDLL:
    """Build (if stale) and load one kernel's library; idempotent."""
    if kernel not in _libs:
        lib_name, source, symbol, argtypes, flags = KERNELS[kernel]
        lib = ctypes.CDLL(build_cuda(lib_name, os.path.join(_CSRC, source),
                                     list(flags)))
        symbols = [(symbol, argtypes)] + [
            (entry, types) for entry, (k, types) in ENTRIES.items()
            if k == kernel]
        for entry, types in symbols:
            fn = getattr(lib, entry)
            fn.argtypes = [*types, _P]
            fn.restype = _I
        _libs[kernel] = lib
    return _libs[kernel]


def _launch(kernel: str, device: torch.device, rows: int, *args,
            entry: str | None = None) -> None:
    """Launch one kernel, through its main C entry point or `entry`, over
    `rows` rows (none for an empty batch)."""
    if device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {device}")
    fn = getattr(load(kernel), entry or KERNELS[kernel][2])
    if rows == 0:
        return
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    launches[kernel] += 1


def autocorr_cuda(x: torch.Tensor) -> torch.Tensor:
    """K3: x [B, N] int32 (N <= 2048) -> r [B, 33] float32."""
    B, N = x.shape
    r = torch.empty((B, 33), dtype=torch.float32, device=x.device)
    _launch("autocorr", x.device, B, x.data_ptr(), r.data_ptr(), B, N)
    return r


def levinson_cuda(r: torch.Tensor, n_valid: torch.Tensor, max_order: int):
    """K4: r [B, 33] float32 + n_valid [B] int32 -> (order [B] int32,
    q [B, 32] int32, cost [B] float32)."""
    B = r.shape[0]
    order = torch.empty(B, dtype=torch.int32, device=r.device)
    q = torch.empty((B, 32), dtype=torch.int32, device=r.device)
    cost = torch.empty(B, dtype=torch.float32, device=r.device)
    _launch("levinson", r.device, B, r.data_ptr(), n_valid.data_ptr(),
            order.data_ptr(), q.data_ptr(), cost.data_ptr(), B, max_order)
    return order, q, cost


def fir_rice_cuda(x: torch.Tensor, c: torch.Tensor, order: torch.Tensor,
                  n_valid: torch.Tensor):
    """K5: x [B, N] int32 (N <= 2048), c [B, 32] int32, order and n_valid
    [B] int32 -> (e [B, N] int32, eff_order [B] int32, counts [B, 32] int32)."""
    B, N = x.shape
    e = torch.empty_like(x)
    eff_order = torch.empty_like(order)
    counts = torch.empty((B, 32), dtype=torch.int32, device=x.device)
    _launch("fir_rice", x.device, B, x.data_ptr(), c.data_ptr(),
            order.data_ptr(), n_valid.data_ptr(), e.data_ptr(),
            eff_order.data_ptr(), counts.data_ptr(), B, N)
    return e, eff_order, counts


def ksel_cuda(counts: torch.Tensor, n_valid: torch.Tensor, k_max: int):
    """K6: counts [B, 32] int32 + n_valid [B] int32 -> (k [B], bits [B])."""
    B = counts.shape[0]
    k = torch.empty(B, dtype=torch.int32, device=counts.device)
    bits = torch.empty(B, dtype=torch.int32, device=counts.device)
    _launch("ksel", counts.device, B, counts.data_ptr(), n_valid.data_ptr(),
            k.data_ptr(), bits.data_ptr(), B, k_max)
    return k, bits


def rice_plan_cuda(counts_res: torch.Tensor, q: torch.Tensor,
                   eff_order: torch.Tensor, n_valid: torch.Tensor, k_max: int,
                   quarter_counts: torch.Tensor | None):
    """K6's render entry: counts_res and q [B, 32], eff_order and n_valid
    [B], quarter_counts [B, 4, 32] or None (int32) -> (q_eff [B, 32],
    [6, B] k_res, kr4, k_coeff, nw_res, nw_coeff, block_bits)."""
    B = q.shape[0]
    q_eff = torch.empty_like(q)
    out = torch.empty((6, B), dtype=torch.int32, device=q.device)
    qc = 0 if quarter_counts is None else quarter_counts.data_ptr()
    _launch("ksel", q.device, B, counts_res.data_ptr(), q.data_ptr(),
            eff_order.data_ptr(), n_valid.data_ptr(), qc, q_eff.data_ptr(),
            out.data_ptr(), B, k_max, entry="sela_rice_plan")
    return q_eff, out


def quarter_counts_cuda(e: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """K8: e [B, N] int32 + n_valid [B] int32 -> [B, 4, 32] int32."""
    B, N = e.shape
    out = torch.empty((B, 4, 32), dtype=torch.int32, device=e.device)
    _launch("quarter_counts", e.device, B, e.data_ptr(), n_valid.data_ptr(),
            out.data_ptr(), B, N)
    return out
