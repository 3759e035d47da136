"""Build the port's native libraries from the checkout's sources at first use.

Libraries go to `sela_tpu_torch/_build/` (gitignored). A library is rebuilt
when any of its sources is newer than it. The compiler writes to a
per-process temporary name that is renamed into place, so concurrent
processes (pytest workers) never load a half-written file. A failed build
raises BuildError carrying the compiler's output; nothing falls back.
"""
from __future__ import annotations

import os
import shutil
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")


class BuildError(RuntimeError):
    pass


def _fresh(out: str, sources: list[str]) -> bool:
    return os.path.exists(out) and all(
        os.path.getmtime(out) >= os.path.getmtime(s) for s in sources
    )


def build_library(name: str, sources: list[str], command: list[str]) -> str:
    """Compile `sources` with `command` (+ `-o out sources`) into
    BUILD_DIR/lib{name}.so unless it is up to date; returns its path.

    The compiler's output of the last build is kept in lib{name}.log
    (for nvcc with -Xptxas -v: registers, shared memory and spills)."""
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if _fresh(out, sources):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [*command, "-o", tmp, *sources], capture_output=True, text=True
    )
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise BuildError(
            f"building lib{name}.so failed ({command[0]}, exit "
            f"{proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    with open(os.path.join(BUILD_DIR, f"lib{name}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_log(name: str) -> str:
    """Compiler output of lib{name}'s last build ('' if none was kept)."""
    path = os.path.join(BUILD_DIR, f"lib{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def nvcc() -> str:
    """Path of the CUDA compiler: CUDA_HOME as torch.utils.cpp_extension
    finds it, else nvcc on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if path is None or not os.path.exists(path):
        path = shutil.which("nvcc")
    if path is None:
        raise BuildError("nvcc not found (no CUDA toolkit on this host)")
    return path


def build_cuda(name: str, source: str, extra_flags: list[str] = ()) -> str:
    """One .cu source with a plain C interface -> lib{name}.so for sm_90a;
    extra_flags go to nvcc after the common ones."""
    return build_library(name, [source], [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        *extra_flags,
    ])
