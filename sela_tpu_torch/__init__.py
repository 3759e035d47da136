"""`sela_tpu_torch` — the PyTorch/CUDA port of the `sela_tpu` codec.

This slice decodes FORMAT.md `.sela` streams on an NVIDIA GPU:
container scan and Rice unpack on the host (native C++), then the integer
Levinson (CUDA kernel, csrc/lpc.cu), the IIR synthesis (CUDA kernel,
csrc/iir.cu) and the inverse mid/side on the device.

The package imports torch and numpy and nothing of the JAX package: the
oracle (`ref`), the constants (`format`), the errors, the native bit I/O
and the stage timer are its own copies.

State shared with `sela_tpu`: the codec has no weights. What crosses
between the two packages is the FORMAT.md bitstream and the decode plan
arrays, and `codec.pipeline.decode_step` takes the JAX `decode_step`'s
layouts as they are — residues [F, C, S] int16/int32, qcoeffs [F, C, 32],
order and sftype [F, C] — so both packages are handed the same numpy
arrays and no converter is needed.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; on a host without CUDA, a call that names no device
raises instead of falling back to the CPU.
"""
