"""Fused attack + bucketing + coordinate-wise robust aggregation (port of
``repro/kernels/robust_agg.py``).

``robust_agg`` takes a dense (n, d) float32 or bfloat16 stack or a
``quantize.WireSrc`` of any wire format (sparse, int8, sign, bf16),
applies the optional omniscient attack (BF / ALIE /
IPM) from the byzantine mask and the good workers' mean / std, the (m, n)
bucket operator W, and the rule (mean / median / trimmed), and returns
the (d,) float32 aggregate. On a CUDA tensor it launches the hand-written
kernel ``csrc/robust_agg.cu`` (or raises), one device operation a call
(the output's allocation aside); on a CPU tensor it runs
``robust_agg_plain``, the step-by-step plain PyTorch version.

The masked twin (fault guard, partial participation): ``valid`` (n,)
select-zeroes invalid worker rows in the load, after the attack and
before W, and ``bvalid`` (m,) over the bucketed rows switches the rule to
``masked_coord_rule``, which fills invalid rows with +inf and picks its
ranks from the valid count c taken on the device.

Under a bfloat16 candidate dtype (a bf16 stack, or a wire whose
``cand_dtype`` is bf16) the forged rows round through bfloat16 before the
select, as the reference's ``_prologue`` rounds them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.aggregators import (coord_median, coord_trimmed_mean,
                                          masked_coord_median,
                                          masked_coord_trimmed_mean,
                                          masked_mean, mean0)
from repro_torch.kernels import _build, _launch
from repro_torch.kernels.norm_agg import (cand_dtype, prologue, src_dims,
                                          stack)

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


def masked_coord_rule(x, bvalid, rule: str, trim: int = 1):
    """The rule over the valid rows of a (m, d) block, the twin of the
    reference's ``_masked_coord_rule_block``: c = Σ bvalid; the mean is
    the sum of all m rows (invalid ones are zeros) divided by max(c, 1);
    median and trimmed mean sort with invalid rows at +inf, the median
    takes 0.5·(rank (c-1)//2 + rank c//2), the trimmed mean sums ranks
    [t, c - t), t = min(trim, (c-1)//2), and divides by max(c - 2t, 1).
    The kernel reads a rank as 0 + v, as the reference's where-sum does,
    so a -0.0 there is +0.0 where this gather keeps it: equal under
    ``==`` and ``torch.equal``."""
    if rule == "mean":
        return masked_mean(x, bvalid)
    if rule == "median":
        return masked_coord_median(x, bvalid)
    if rule == "trimmed":
        return masked_coord_trimmed_mean(x, bvalid, trim)
    raise ValueError(rule)


def robust_agg_plain(x, w_mat=None, mask=None, good_mean=None,
                     good_std=None, valid=None, bvalid=None, *,
                     rule: str = "median", trim: int = 1, attack=None):
    """Plain PyTorch version: decode (wire), round-trip, add the base,
    attack select, valid select, W @ x in float32, sort over the workers,
    pick (the masked rule under ``bvalid``)."""
    xb = prologue(stack(x), w_mat, mask, good_mean, good_std, attack, valid,
                  cand_dtype(x))
    if bvalid is not None:
        return masked_coord_rule(xb, bvalid > 0, rule, trim)
    return coord_rule(xb, rule, trim)


def robust_agg(x, w_mat=None, mask=None, good_mean=None, good_std=None,
               valid=None, bvalid=None, *, rule: str = "median",
               trim: int = 1, attack=None):
    """(n, d) stack or WireSrc -> (d,) float32 aggregate. CPU tensors take
    the plain version; CUDA tensors the kernel."""
    robust_agg.calls += 1
    if _launch.on_cpu("robust_agg", x.device):
        return robust_agg_plain(x, w_mat, mask, good_mean, good_std, valid,
                                bvalid, rule=rule, trim=trim, attack=attack)
    return _launch_kernel(x, w_mat, mask, good_mean, good_std, valid, bvalid,
                          rule, trim, attack)


robust_agg.calls = 0            # every call, plain or kernel
_launch.reset_counts(robust_agg)    # kernel launches, split per load


def _lib():
    lib = _build.load("robust_agg")
    if lib.robust_agg_launch.argtypes is None:
        lib.robust_agg_launch.argtypes = _launch.SRC_ARGTYPES + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.robust_agg_launch.restype = ctypes.c_int
    return lib


def _launch_kernel(x, w_mat, mask, good_mean, good_std, valid, bvalid, rule,
                   trim, attack):
    if rule not in RULES:
        raise ValueError(rule)
    n, d = src_dims(x)
    lib = _lib()
    args, load = _launch.src_args("robust_agg", x, n, d, mask, good_mean,
                                  good_std, attack, valid)
    m, w_ptr = _launch.bucket_args("robust_agg", w_mat, n, x.device)
    bv_ptr = None
    if bvalid is not None:
        bv_ptr, is_u8 = _launch.mask_arg("robust_agg", "bvalid", bvalid,
                                         x.device, (m,))
        args[-1] |= _launch.BVALID_U8 if is_u8 else 0
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    err = lib.robust_agg_launch(*args, w_ptr, m, bv_ptr, RULES.index(rule),
                                int(trim), out.data_ptr(),
                                _launch.stream(x.device))
    _launch.raise_on("robust_agg", err)
    _launch.count(robust_agg, load, valid is not None or bvalid is not None)
    return out
