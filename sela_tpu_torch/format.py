"""Frozen bitstream constants for the SELA-family `sela_tpu` profile v1.

Copy of sela_tpu/format/__init__.py for the PyTorch port, which imports
nothing of the JAX package. Normative spec: FORMAT.md. The numpy oracle
(sela_tpu_torch.ref) is the executable form of that spec; every other
implementation (torch ops, CUDA kernels, native C++ bit I/O) must agree
with it bit-exactly.

Reference provenance: the sahaRatul/sela mount was empty at build time
(SURVEY.md header); constants tagged *(sela-recalled)* in FORMAT.md follow
SURVEY.md SS2's recollection of the public repo (upstream:src/file/sela_file.cpp,
upstream:src/lpc/*, upstream:src/rice/* -- path-level cites, no line numbers
available).
"""

MAGIC = b"SeLa"            # file magic, 4 ASCII bytes          (sela-recalled)
SYNC = 0xAA55FF00          # per-frame sync word, u32 LE        (sela-recalled)
TAG_MAGIC = b"SeTg"        # optional metadata trailer magic (APEv2 parity)
TAG_MAX_BYTES = 1 << 24    # sanity cap on the tags block payload

FRAME_SIZE = 2048          # samples per channel per frame      (sela-recalled)
MAX_ORDER = 32             # max LPC order
REF_Q = 20                 # Q-format of reflection + LPC coefficients
REF_ONE = 1 << REF_Q       # 1.0 in Q20

Q_CLAMP_LO = -64           # quantized reflection coefficient range
Q_CLAMP_HI = 63

RICE_K_MAX = 30            # optimal-k search range [0, RICE_K_MAX]
RICE_K_ESCAPE = 31         # verbatim 32-bit escape code

# Partitioned residues (FORMAT.md §Partitioned residues): kRes byte == 32
# marks a residue block split into RESIDUE_PARTS sub-blocks with independent
# k, packed bit-contiguously. Encoder-optional (BitstreamProfile
# residue_partition=4); all decoders accept it.
RICE_PARTITION_MARKER = 32
RESIDUE_PARTS = 4

COEFF_BIT_COST = 7         # approx bits/coefficient used by order selection

# Order-selection quantization-noise penalty (r5, non-normative encoder
# tuning): the float Levinson err_m is the residual variance with UNQUANTIZED
# coefficients, so it keeps falling with order while the real residual —
# filtered with 7-bit-companded reflections — stops improving; the unpenalized
# model overshot the true optimum order by ~6 on the pinned corpus, costing
# 5.6% stream size (RATIO_SWEEP.json). Each quantized tap contributes noise
# on the order of (quantizer step)^2 * r0 = 2^-12 * r0, so order selection
# minimizes N/2*log2(err_m + m * ORDER_QNOISE_PENALTY * r0) + 7m. Measured:
# captures 92% of the exact-search gain at zero render cost, never loses on
# held-out content (chords +5.1%, tone +13.9%, ar/noise/impulse +-0.0%).
ORDER_QNOISE_PENALTY = 2.0 ** -12

# Subframe types
SF_DIRECT = 0
SF_MID = 1
SF_SIDE = 2

# Residue overflow guard: encoder falls back to order 0 if any |e| >= 2**30
RESIDUE_LIMIT = 1 << 30

MAX_FRAME_SAMPLES = FRAME_SIZE  # u16 field; invariant numSamples <= 2048
