"""Where the looping kernels' time goes, by timing variants of them on one
NVIDIA card.

    python3 kernel_variants.py [variant ...]

Each variant is the kernels of ``src/repro_torch/kernels/csrc`` with one
design choice of ``robust_agg`` / ``weighted_sum`` undone or one step cut
out, built from an edited copy under ``build/variants/<name>/`` (the
sources in the checkout stay as they are). The timed cases are
``chip_smoke.py``'s full-width ones (n = 8; the dense float32 stack and
the bfloat16 stack at d = 117,440,512, the RandK 0.1 wire at d = 2²²),
each variant's device ms from torch.profiler. Variants that cut a step
out give wrong aggregates: they measure that step's cost and nothing
else. Writes ``chiprun_out/kernel_variants.json``; needs a CUDA card.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "variants"
sys.path.insert(0, str(ROOT / "src"))

# (file, text, replacement) edits of each variant
_RANGE = "constexpr bool RANGE = LOAD == LOAD_SPARSE;"
VARIANTS = {
    "final": [],
    # the sparse walk cut out: the tile stays zero (wrong aggregates)
    "no_walk": [("agg_prologue.cuh",
                 "  for (int i0 = warp; i0 < a.n; i0 += 2 * WARPS) {\n"
                 "    const int i1 = i0 + WARPS;\n    bool more0",
                 "  for (int i0 = warp; i0 < 0; i0 += 2 * WARPS) {\n"
                 "    const int i1 = i0 + WARPS;\n    bool more0")],
    # the range search replaced by an estimate (wrong aggregates)
    "no_search": [("agg_prologue.cuh",
                   "    warp_lower_bound2(x0, x1, a.k, lo, &p0, &p1);",
                   "    p0 = p1 = (int)((long long)a.k * lo / a.d);")],
    # registers a thread uncapped (no minimum of blocks an SM)
    "no_min_blocks": [
        ("robust_agg.cu", "__launch_bounds__(TILE, MB * V <= 16 ? "
                          "MIN_BLOCKS(LOAD) : 1)", "__launch_bounds__(TILE)"),
        ("norm_agg.cu", "__launch_bounds__(TILE, V <= 4 ? 8 : 1)",
         "__launch_bounds__(TILE)")],
    # a contiguous range of groups a block on every load
    "contiguous": [(f, _RANGE, "constexpr bool RANGE = true;")
                   for f in ("robust_agg.cu", "norm_agg.cu")],
}


def make(name, edits):
    """An edited copy of the sources for ``name``."""
    src = OUT / name / "csrc"
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(CSRC, src)
    for fname, old, new in edits:
        path = src / fname
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: {fname} has no {old!r}")
        path.write_text(text.replace(old, new))
    return src


def build(names):
    """Every variant's robust_agg and norm_agg, one process each, at
    once."""
    procs = {}
    for name in names:
        code = ("import sys; from pathlib import Path; sys.path.insert(0, "
                f"{str(ROOT / 'src')!r}); from repro_torch.kernels import "
                f"_build as B; B.CSRC = Path({str(OUT / name / 'csrc')!r});"
                f" B.BUILD_DIR = Path({str(OUT / name / 'lib')!r}); "
                "B.build(['robust_agg', 'norm_agg'])")
        procs[name] = subprocess.Popen([sys.executable, "-c", code],
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.core.attacks import CoordAttack
    from repro_torch.kernels import _build, norm_agg, robust_agg as RA
    names = argv or list(VARIANTS)
    for name in names:
        make(name, VARIANTS[name])
    build(names)
    dev = torch.device("cuda")
    alie = CoordAttack("ALIE", 1.06)
    inputs = {kind: C.make_inputs(8, d, k, base_rows, 2, dev, kind)[0]
              for kind, d, k, base_rows in (
                  ("dense", 117_440_512, None, 0),
                  ("dense_bf16", 117_440_512, None, 0),
                  ("sparse_wire", 1 << 22, 419_430, 1))}
    wn = torch.rand(8, device=dev) + 0.1
    card = C.gpu_line()
    rows = {}
    for name in names:
        _build.CSRC = OUT / name / "csrc"
        _build.BUILD_DIR = OUT / name / "lib"
        _build._LIBS.clear()
        row = {}
        for kind, (x, w, mask, mean, std) in inputs.items():
            row[f"robust_agg {kind}"] = C.device_profile(
                lambda: RA.robust_agg(x, w, mask, mean, std, rule="median",
                                      attack=alie))[0]
            if kind != "dense_bf16":
                row[f"weighted_sum {kind}"] = C.device_profile(
                    lambda: norm_agg.weighted_sum(x, wn, mask, mean, std,
                                                  attack=alie))[0]
        rows[name] = row
        print(f"[variant {name}] device ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
              + f" [{card}]", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_variants.json").write_text(json.dumps(
        {"card": card, "device_ms": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
