"""`sela_tpu_torch` — the PyTorch/CUDA port of the `sela_tpu` codec.

It encodes WAV to FORMAT.md `.sela` streams and decodes them on an NVIDIA
GPU (`codec.encoder`, `codec.decoder`), a batch of files at a time
(`codec.corpus`) or a chunk of frames at a time (`codec.stream`): the
container and the Rice bitstream on the host (native C++), the analysis,
the render and the synthesis in hand-written CUDA kernels (`csrc/`). `cli`
is its command line and `bench` its benchmark.

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
