"""The plain reference of the benchmark: the served pipeline written again
in plain PyTorch, from the published descriptions and the reference
repository's semantics, in float32 with TF32 off.

It imports nothing of the program under test and takes nothing that the
program made: weights come as flax-layout trees of tensors that the
benchmark drew or loaded itself, the 3DMM pack as the benchmark's own
arrays. Each module runs under a :class:`~perfbench.reference.precision.
Precision`, so the same code computes the control in fp8.
"""
