"""Hand-written Hopper kernels (port of ``repro.kernels``).

- robust_agg: fused attack + bucketing + coordinate-wise mean / median /
  trimmed mean over n <= 64 worker rows, dense or from the sparse RandK
  wire; CUDA C++ in ``csrc/robust_agg.cu``.
- norm_agg: the Krum / RFA kernels ``pair_gram``, ``rfa_iter`` and
  ``weighted_sum`` on the same loads (``csrc/norm_agg.cu``), their rule
  drivers, the bucket operator and the plain attack/bucket prologue.
- quantize: the sparse wire format.

The kernels share one block load, ``csrc/agg_prologue.cuh``, and are
built at first use by ``_build``; ``_launch`` holds what their wrappers
share. Every kernel has a plain PyTorch version beside it, taken for CPU
tensors only; a CUDA tensor launches the kernel or raises.
"""
