"""Encoder profile of the port — copy of sela_tpu/config.py::BitstreamProfile.

Only the knobs that change the emitted bytes are copied; the JAX package's
RuntimeConfig (engine and kernel selection) has no counterpart here, as the
port routes kernels by device alone. Defaults are the FORMAT.md v1 profile,
and validation enforces the container's hard caps with the same messages as
the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

from .format import FRAME_SIZE, MAX_ORDER, RESIDUE_PARTS, RICE_K_MAX


@dataclass(frozen=True)
class BitstreamProfile:
    """Encoder-side choices that affect emitted bytes (the decoder needs
    none of them: the container is self-describing within the caps)."""

    frame_size: int = FRAME_SIZE        # samples/channel/frame, <= FRAME_SIZE
    max_order: int = MAX_ORDER          # LPC order search cap, <= MAX_ORDER
    rice_k_max: int = RICE_K_MAX        # optimal-k search cap, <= RICE_K_MAX
    # mid/side decision rule (non-normative — any choice decodes exactly):
    #   auto  — per-frame modeled-cost rule (the render runs on the winner
    #           rows only)
    #   exact — per-frame exact padded-bits rule (renders all candidates)
    #   off   — direct L/R subframes only (mandatory for 32-bit PCM)
    mid_side: str = "auto"
    # 1 = one k per residue block (v1 default); RESIDUE_PARTS (4) = adaptive
    # partitioned residues (FORMAT.md §Partitioned residues)
    residue_partition: int = 1

    def validate(self) -> "BitstreamProfile":
        if not 32 <= self.frame_size <= FRAME_SIZE:
            raise ValueError(
                f"frame_size {self.frame_size} outside [32, {FRAME_SIZE}] "
                f"(container carries a u16 count capped at {FRAME_SIZE})")
        if not 1 <= self.max_order <= MAX_ORDER:
            raise ValueError(f"max_order {self.max_order} outside [1, {MAX_ORDER}]")
        if not 0 <= self.rice_k_max <= RICE_K_MAX:
            raise ValueError(f"rice_k_max {self.rice_k_max} outside [0, {RICE_K_MAX}]")
        if self.mid_side not in ("auto", "exact", "off"):
            raise ValueError(
                f"mid_side must be auto|exact|off, got {self.mid_side!r}")
        if self.residue_partition not in (1, RESIDUE_PARTS):
            raise ValueError(
                f"residue_partition must be 1 or {RESIDUE_PARTS}, "
                f"got {self.residue_partition}")
        return self

    @property
    def is_v1_default(self) -> bool:
        return self == BitstreamProfile()
