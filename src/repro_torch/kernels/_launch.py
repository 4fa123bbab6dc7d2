"""What every CUDA aggregation launch shares: argument checks, the
worker-stack arguments that lead each fused entry point's C signature
(``SRC_PARAMS`` in ``csrc/agg_prologue.cuh``), in that order, the
launch counts per load, and the dense stack of the blocked kernels.
Nothing here launches a device operation: masks go as they are (bool as
a uint8 view), and the sparse wire goes without row pointers (each kernel
finds its bounds on the card)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.aggregators import MAX_FUSED_WORKERS
from repro_torch.core.attacks import attack_code
from repro_torch.kernels import quantize

_P, _I, _Q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SRC_ARGTYPES = ([_P] * 3 + [_I, _P, _Q, _P, _I, _P, _I] + [_P] * 4
                + [_I, ctypes.c_float, _I, _I, _I, _Q, _I])
# u8_masks bits of SRC_PARAMS: which masks come as bool bytes
MASK_U8, VALID_U8, BVALID_U8 = 1, 2, 4

# the sources a fused kernel loads its worker stack from, in the order of
# the LOAD_* codes of csrc/agg_prologue.cuh: the dense float32 / bfloat16
# stack, or a wire payload (quantize.WireSrc) of each format
LOADS = ("dense", "dense_bf16", "sparse", "int8", "sign", "bf16")


def load_of(x) -> str:
    """The load a kernel input takes: its wire format, or the dense stack
    of its dtype."""
    if isinstance(x, quantize.WireSrc):
        return x.fmt
    return "dense_bf16" if x.dtype == torch.bfloat16 else "dense"


def reset_counts(fn) -> None:
    """Zero a fused wrapper's counts: ``launches`` and ``masked_launches``
    (those with a validity mask), and both split per load
    (``load_launches``, ``masked_load_launches``)."""
    fn.launches = fn.masked_launches = 0
    fn.load_launches = dict.fromkeys(LOADS, 0)
    fn.masked_load_launches = dict.fromkeys(LOADS, 0)


def count(fn, load: str, masked: bool) -> None:
    """One kernel launch of ``fn`` on ``load``."""
    fn.launches += 1
    fn.load_launches[load] += 1
    if masked:
        fn.masked_launches += 1
        fn.masked_load_launches[load] += 1


def on_cpu(who: str, device) -> bool:
    """A CPU tensor takes the plain version, a CUDA one the kernel; any
    other device raises."""
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {device}")
    return False


def check(who, name, t, device, dtype, shape) -> int:
    """Data pointer of ``t`` after checking what the kernel takes."""
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{who}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")
    return t.data_ptr()


def mask_arg(who, name, m, device, shape):
    """(pointer, is_bytes) of a mask the kernels read: a bool mask as a
    zero-copy uint8 view (bytes, nonzero set), a float32 one as it is
    (> 0 set); no conversion is launched."""
    if m.dtype == torch.bool:
        return check(who, name, m.view(torch.uint8), device, torch.uint8,
                     shape), True
    return check(who, name, m, device, torch.float32, shape), False


def src_args(who, x, n, d, mask, good_mean, good_std, attack, valid=None):
    """(args, load): the ``SRC_PARAMS`` of a launch on the dense (n, d)
    float32 or bfloat16 stack or the ``quantize.WireSrc`` ``x``, and the
    load's name. ``valid`` (fault guard) is the optional (n,) row-validity
    mask, taken like ``mask``."""
    if not 1 <= n <= MAX_FUSED_WORKERS:
        raise ValueError(f"{who} kernel takes 1..{MAX_FUSED_WORKERS} "
                         f"workers, got {n}")
    device = x.device
    f32, i8 = torch.float32, torch.int8
    x_ptr = vals = idx = q8 = qs = base = None
    k = q8_ld = qs_ld = base_rows = 0
    load = load_of(x)
    if isinstance(x, quantize.WireSrc):
        if x.cand_dtype not in (f32, torch.bfloat16):
            raise TypeError(f"{who} kernel: candidates of {x.cand_dtype}")
        cand_bf16 = x.cand_dtype == torch.bfloat16
        arr = dict(x.arrays)
        if load == "sparse":
            k = arr["vals"].shape[1]
            vals = check(who, "vals", arr["vals"], device, f32, (n, k))
            idx = check(who, "idx", arr["idx"], device, torch.int32, (n, k))
        elif load == "int8":
            qs_ld = -(-d // quantize.INT8_BLOCK)
            q8_ld = qs_ld * quantize.INT8_BLOCK
            q8 = check(who, "lev", arr["lev"], device, i8, (n, q8_ld))
            qs = check(who, "norms", arr["norms"], device, f32, (n, qs_ld))
        elif load == "sign":
            q8_ld, qs_ld = d, 1
            q8 = check(who, "signs", arr["signs"], device, i8, (n, d))
            qs = check(who, "scale", arr["scale"], device, f32, (n, 1))
        elif load == "bf16":
            x_ptr = check(who, "vals", arr["vals"], device, torch.bfloat16,
                          (n, d))
        else:
            raise ValueError(f"{who} kernel: wire format {x.fmt!r}")
        if x.base is not None:
            base_rows = x.base.shape[0]
            if base_rows not in (1, n):
                raise ValueError(f"{who}: base has {base_rows} rows")
            base = check(who, "base", x.base, device, f32, (base_rows, d))
    else:
        cand_bf16 = load == "dense_bf16"
        x_ptr = check(who, "x", x, device,
                      torch.bfloat16 if cand_bf16 else f32, (n, d))
    code = attack_code(attack)
    mask_ptr = mean_ptr = std_ptr = valid_ptr = None
    u8 = 0
    if code:
        if mask is None:
            raise ValueError(f"{who}: an attack needs the byzantine mask")
        mask_ptr, is_u8 = mask_arg(who, "mask", mask, device, (n,))
        u8 |= MASK_U8 if is_u8 else 0
        if attack.kind in ("ALIE", "IPM"):
            mean_ptr = check(who, "good_mean", good_mean, device, f32, (d,))
        if attack.kind == "ALIE":
            std_ptr = check(who, "good_std", good_std, device, f32, (d,))
    if valid is not None:
        valid_ptr, is_u8 = mask_arg(who, "valid", valid, device, (n,))
        u8 |= VALID_U8 if is_u8 else 0
    args = [x_ptr, vals, idx, k, q8, q8_ld, qs, qs_ld, base,
            base_rows, mask_ptr, valid_ptr, mean_ptr, std_ptr, code,
            float(attack.param) if code else 0.0, LOADS.index(load),
            int(cand_bf16), n, d, u8]
    return args, load


def dense_args(who, x):
    """(m, d, pointer) of a blocked kernel's dense (m, d) float32 stack."""
    if x.dim() != 2 or min(x.shape) < 1:
        raise ValueError(f"{who}: x must be a non-empty (m, d) stack, got "
                         f"shape {tuple(x.shape)}")
    m, d = x.shape
    return m, d, check(who, "x", x, x.device, torch.float32, (m, d))


def bucket_args(who, w_mat, n, device):
    """(m, pointer) of the optional (m, n) bucket operator W."""
    if w_mat is None:
        return n, None
    m = w_mat.shape[0]
    return m, check(who, "w_mat", w_mat, device, torch.float32, (m, n))


def stream(device) -> int:
    """The current CUDA stream of ``device`` as a raw handle (without
    building a ``torch.cuda.Stream``, which costs microseconds a call)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index if device.index is not None
                   else torch.cuda.current_device())
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(who: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{who} kernel launch failed: CUDA error {err}")
