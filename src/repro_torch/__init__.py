"""PyTorch/CUDA port of the TokenScale reproduction (reference: ``repro``).

The port imports neither JAX nor the reference package.  Entry points take
an explicit ``device`` ("cuda" by default; the tests pass "cpu"), and the
attention kernels run where the tensors are: a hand-written Hopper kernel
on a CUDA device, the plain PyTorch version on the CPU.
"""
