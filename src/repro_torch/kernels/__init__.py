"""Hand-written Hopper kernels (port of ``repro.kernels``).

- robust_agg: fused attack + bucketing + coordinate-wise mean / median /
  trimmed mean over n <= 64 worker rows, from a dense float32 or bfloat16
  stack or any wire (sparse RandK / TopK, int8, sign, bf16); CUDA C++ in
  ``csrc/robust_agg.cu``.
- norm_agg: the Krum / RFA kernels ``pair_gram``, ``rfa_iter`` and
  ``weighted_sum`` on the same loads (``csrc/norm_agg.cu``), their rule
  drivers, the bucket operator and the plain attack/bucket prologue; and
  the giant-n tier's blocked kernels ``pair_gram_blocked``,
  ``sqdist_to_blocked`` and ``weighted_sum_blocked`` on dense stacks of
  any row count (``csrc/norm_agg_blocked.cu``) with their drivers.
- quantize: the wire formats (sparse, int8, sign, bf16: packing, decode,
  the plain reconstruction ``recon``); TopK's selection ``topk_select``
  and its support ``topk_support`` (an exact radix select of each row's
  threshold and an ordered compaction, ``csrc/topk_select.cu``) and the
  block-ℓ2 quantizer ``block_quantize`` (``csrc/block_quantize.cu``).
- ops: the public entry points over stacked workers (``robust_agg``,
  ``rfa_agg``, ``krum_agg`` on float32 or bfloat16 stacks, ``wire_agg``
  on any wire, ``block_quantize``) and the oracles of ``ref``, the plain
  reference versions.

The fused kernels share one block load, ``csrc/agg_prologue.cuh``, a
template over the six sources (``_launch.LOADS``), which also takes the
fault guard's (and partial participation's) ``valid`` select;
``robust_agg`` has the masked coordinate rule beside the plain ones, and
the drivers take the bucket validity ``bvalid``. All
are built at first use by ``_build``; ``_launch`` holds what their wrappers
share. Every kernel has a plain PyTorch version beside it, taken for CPU
tensors only; a CUDA tensor launches the kernel or raises.
"""
