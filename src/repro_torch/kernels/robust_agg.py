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

from repro_torch.core.aggregators import (MAX_FUSED_WORKERS, coord_median,
                                          coord_trimmed_mean, mean0)
from repro_torch.core.attacks import attack_code
from repro_torch.kernels import _build, quantize
from repro_torch.kernels.norm_agg import prologue, src_dims

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
    if isinstance(x, quantize.WireSrc):
        xf = quantize.recon(x)
    else:
        xf = x.float()
    xb = prologue(xf, w_mat, mask, good_mean, good_std, attack)
    return coord_rule(xb, rule, trim)


def robust_agg(x, w_mat=None, mask=None, good_mean=None, good_std=None, *,
               rule: str = "median", trim: int = 1, attack=None):
    """(n, d) stack or WireSrc -> (d,) float32 aggregate. CPU tensors take
    the plain version; CUDA tensors the kernel."""
    device = x.device
    if device.type == "cpu":
        return robust_agg_plain(x, w_mat, mask, good_mean, good_std,
                                rule=rule, trim=trim, attack=attack)
    if device.type != "cuda":
        raise ValueError(f"robust_agg: unsupported device {device}")
    return _launch(x, w_mat, mask, good_mean, good_std, rule, trim, attack)


robust_agg.launches = 0         # kernel launches since the last reset
robust_agg.wire_launches = 0    # of which on a sparse wire payload


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_int]
             + [ctypes.c_void_p] * 3
             + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_void_p])


def _lib():
    lib = _build.load("robust_agg")
    if lib.robust_agg_launch.argtypes is None:
        lib.robust_agg_launch.argtypes = _ARGTYPES
        lib.robust_agg_launch.restype = ctypes.c_int
        lib.robust_agg_tile.argtypes = []
        lib.robust_agg_tile.restype = ctypes.c_int
    return lib


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"robust_agg: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"robust_agg: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"robust_agg: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"robust_agg: {name} must be contiguous")
    return t.data_ptr()


def _launch(x, w_mat, mask, good_mean, good_std, rule, trim, attack):
    if rule not in RULES:
        raise ValueError(rule)
    n, d = src_dims(x)
    if not 1 <= n <= MAX_FUSED_WORKERS:
        raise ValueError(f"robust_agg kernel takes 1..{MAX_FUSED_WORKERS} "
                         f"workers, got {n}")
    device = x.device
    f32 = torch.float32
    lib = _lib()
    ptr = {"x": None, "vals": None, "idx": None, "starts": None,
           "base": None}
    k = base_rows = 0
    keep = []                      # tensors made here, alive until launch
    if isinstance(x, quantize.WireSrc):
        if x.fmt != "sparse" or x.cand_dtype != f32:
            raise NotImplementedError(
                f"robust_agg kernel: {x.fmt} / {x.cand_dtype} wire loads "
                "are not ported yet (ROADMAP queue 2)")
        arr = dict(x.arrays)
        k = arr["vals"].shape[1]
        ptr["vals"] = _check("vals", arr["vals"], device, f32, (n, k))
        ptr["idx"] = _check("idx", arr["idx"], device, torch.int32, (n, k))
        starts = quantize.wire_starts(arr["idx"], d, lib.robust_agg_tile())
        keep.append(starts)
        ptr["starts"] = starts.data_ptr()
        if x.base is not None:
            base_rows = x.base.shape[0]
            if base_rows not in (1, n):
                raise ValueError(f"robust_agg: base has {base_rows} rows")
            ptr["base"] = _check("base", x.base, device, f32, (base_rows, d))
    else:
        ptr["x"] = _check("x", x, device, f32, (n, d))
    m = n
    w_ptr = None
    if w_mat is not None:
        m = w_mat.shape[0]
        w_ptr = _check("w_mat", w_mat, device, f32, (m, n))
    code = attack_code(attack)
    mask_ptr = mean_ptr = std_ptr = None
    if code:
        if mask is None:
            raise ValueError("robust_agg: an attack needs the byzantine mask")
        if mask.dtype == torch.bool:
            mask = mask.float()
            keep.append(mask)
        mask_ptr = _check("mask", mask, device, f32, (n,))
        if attack.kind in ("ALIE", "IPM"):
            mean_ptr = _check("good_mean", good_mean, device, f32, (d,))
        if attack.kind == "ALIE":
            std_ptr = _check("good_std", good_std, device, f32, (d,))
    out = torch.empty(d, dtype=f32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.robust_agg_launch(
        ptr["x"], ptr["vals"], ptr["idx"], ptr["starts"], k, ptr["base"],
        base_rows, w_ptr, m, mask_ptr, mean_ptr, std_ptr, code,
        float(attack.param) if code else 0.0, RULES.index(rule), int(trim),
        n, d, out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"robust_agg kernel launch failed: CUDA error "
                           f"{err}")
    robust_agg.launches += 1
    robust_agg.wire_launches += int(k > 0)
    return out
