"""Batched torch ops: the plain versions of the kernels and their dispatch."""
