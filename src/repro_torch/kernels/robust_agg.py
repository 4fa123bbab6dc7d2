"""Fused attack + bucketing + coordinate-wise robust aggregation (port of
``repro/kernels/robust_agg.py``).

``robust_agg`` takes a dense (n, d) float32 stack or a sparse
``quantize.WireSrc``, applies the optional omniscient attack (BF / ALIE /
IPM) from the byzantine mask and the good workers' mean / std, the (m, n)
bucket operator W, and the rule (mean / median / trimmed), and returns
the (d,) float32 aggregate. On a CUDA tensor it launches the hand-written
kernel ``csrc/robust_agg.cu`` (or raises); on a CPU tensor it runs
``robust_agg_plain``, the step-by-step plain PyTorch version. Not ported
yet (ROADMAP queue 2): the masked twin (fault guard), the int8 / sign /
bf16 wire loads and bf16 candidates.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.aggregators import (coord_median, coord_trimmed_mean,
                                          mean0)
from repro_torch.kernels import _build, _launch, quantize
from repro_torch.kernels.norm_agg import prologue, src_dims, stack

RULES = ("mean", "median", "trimmed")


def coord_rule(x, rule: str, trim: int = 1):
    """The rule over the rows of a (m, d) block (``_coord_rule_block``)."""
    if rule == "mean":
        return mean0(x)
    if rule == "median":
        return coord_median(x)
    if rule == "trimmed":
        return coord_trimmed_mean(x, trim)
    raise ValueError(rule)


def robust_agg_plain(x, w_mat=None, mask=None, good_mean=None,
                     good_std=None, *, rule: str = "median", trim: int = 1,
                     attack=None):
    """Plain PyTorch version: decode (wire), round-trip, add the base,
    attack select, W @ x in float32, sort over the workers, pick."""
    xb = prologue(stack(x), w_mat, mask, good_mean, good_std, attack)
    return coord_rule(xb, rule, trim)


def robust_agg(x, w_mat=None, mask=None, good_mean=None, good_std=None, *,
               rule: str = "median", trim: int = 1, attack=None):
    """(n, d) stack or WireSrc -> (d,) float32 aggregate. CPU tensors take
    the plain version; CUDA tensors the kernel."""
    robust_agg.calls += 1
    if _launch.on_cpu("robust_agg", x.device):
        return robust_agg_plain(x, w_mat, mask, good_mean, good_std,
                                rule=rule, trim=trim, attack=attack)
    return _launch_kernel(x, w_mat, mask, good_mean, good_std, rule, trim,
                          attack)


robust_agg.calls = 0            # every call, plain or kernel
robust_agg.launches = 0         # kernel launches since the last reset
robust_agg.wire_launches = 0    # of which on a sparse wire payload


def _lib():
    lib = _build.load("robust_agg")
    if lib.robust_agg_launch.argtypes is None:
        lib.robust_agg_launch.argtypes = _launch.SRC_ARGTYPES + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.robust_agg_launch.restype = ctypes.c_int
        lib.robust_agg_tile.argtypes = []
        lib.robust_agg_tile.restype = ctypes.c_int
    return lib


def _launch_kernel(x, w_mat, mask, good_mean, good_std, rule, trim, attack):
    if rule not in RULES:
        raise ValueError(rule)
    n, d = src_dims(x)
    lib = _lib()
    args, keep = _launch.src_args("robust_agg", x, n, d, mask, good_mean,
                                  good_std, attack, lib.robust_agg_tile())
    m, w_ptr = _launch.bucket_args("robust_agg", w_mat, n, x.device)
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    err = lib.robust_agg_launch(*args, w_ptr, m, RULES.index(rule),
                                int(trim), out.data_ptr(),
                                _launch.stream(x.device))
    _launch.raise_on("robust_agg", err)
    robust_agg.launches += 1
    robust_agg.wire_launches += int(isinstance(x, quantize.WireSrc))
    return out
