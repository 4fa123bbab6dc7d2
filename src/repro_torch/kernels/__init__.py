"""Hand-written Hopper kernels (port of ``repro.kernels``).

- robust_agg: fused attack + bucketing + coordinate-wise mean / median /
  trimmed mean over n <= 64 worker rows, dense or from the sparse RandK
  wire; CUDA C++ in ``csrc/robust_agg.cu``, built at first use by
  ``_build``.
- norm_agg: the bucket operator and the plain attack/bucket prologue.
- quantize: the sparse wire format.

Every kernel has a plain PyTorch version beside it, taken for CPU tensors
only; a CUDA tensor launches the kernel or raises.
"""
