"""Where the looping kernels' and the blocked Gram's time goes, by timing
variants of them on one NVIDIA card.

    python3 kernel_variants.py [variant ...]

Each variant is the kernels of ``src/repro_torch/kernels/csrc`` with one
design choice of ``robust_agg`` / ``weighted_sum`` or of
``pair_gram_blocked`` undone or one step cut out, built from an edited
copy under ``build/variants/<name>/`` (the sources in the checkout stay
as they are). The looping kernels' cases are ``chip_smoke.py``'s
full-width ones (n = 8; the dense float32 stack and the bfloat16 stack
at d = 117,440,512, the RandK 0.1 wire at d = 2²²); the Gram's are the
giant-n main path's 128 × 1 and 128 × 123 and the full-width 128 × 2²²
and 1024 × 2²⁰, each with its error against the plain version, as a
share of the largest entry. Each variant's device ms is from
torch.profiler. Variants that cut a step out give wrong results: they
measure that step's cost and nothing else. Writes
``chiprun_out/kernel_variants.json``; needs a CUDA card.
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
_GRAM = "norm_agg_blocked.cu"
GRAM_VARIANTS = {
    "gram": [],
    # the tensor-core products cut out (wrong Grams)
    "gram_no_products": [(_GRAM, "for (int k = 0; k < GK; k += 8) {",
                          "for (int k = 0; k < 0; k += 8) {")],
    # the split into hi and lo cut out (wrong Grams)
    "gram_no_split": [(_GRAM, "      split_half(sm.hi(s, 0), sm.lo(s, 0), "
                              "g, t);\n      if (!diag) split_half(sm.hi(s,"
                              " 1), sm.lo(s, 1), g, t);\n", "")],
    # the output passes cut out (G unwritten)
    "gram_no_output": [(_GRAM, "for (int pass = 0; pass < 2; ++pass) {",
                        "for (int pass = 0; pass < 0; ++pass) {")],
    # hi and lo rounded by the conversion instruction, not integer steps
    "gram_cvt": [(_GRAM, "  return __uint_as_float((__float_as_uint(x) + "
                         "0x1000u) & 0xFFFFE000u);",
                  "  unsigned r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : "
                  "\"=r\"(r) : \"f\"(x));\n  return __uint_as_float(r);")],
    # the running sums folded every 2048 columns (the reference's column
    # tile), not every 128
    "gram_fold_2048": [(_GRAM, "constexpr int G_FOLD = 4;",
                        "constexpr int G_FOLD = 64;")],
    # slab s - 1 handed back before slab s + 1 is split (the design hands
    # it back after)
    "gram_release_early": [(
        _GRAM,
        "      if (s + 1 < ns) prep(s + 1);\n      const bool at_fold",
        "      wgmma_wait<1>();\n      mbar_arrive_if(&sm.empty[(s + G_RING - "
        "1) % G_RING], s > 0 && t == 0);\n      if (s + 1 < ns) prep(s + 1);"
        "\n      const bool at_fold"),
        (_GRAM,
         "      pin(acc);\n      mbar_arrive_if(&sm.empty[(s + G_RING - 1) % "
         "G_RING], s > 0 && t == 0);\n      if (at_fold) {",
         "      pin(acc);\n      if (at_fold) {")],
}
GRAM_CASES = [(128, 1), (128, 123), (128, 1 << 22), (1024, 1 << 20)]


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
    """Every variant's libraries (the looping kernels', or the blocked
    ones for a Gram variant), one process each, at once."""
    procs = {}
    for name in names:
        libs = (['norm_agg_blocked'] if name in GRAM_VARIANTS
                else ['robust_agg', 'norm_agg'])
        code = ("import sys; from pathlib import Path; sys.path.insert(0, "
                f"{str(ROOT / 'src')!r}); from repro_torch.kernels import "
                f"_build as B; B.CSRC = Path({str(OUT / name / 'csrc')!r});"
                f" B.BUILD_DIR = Path({str(OUT / name / 'lib')!r}); "
                f"B.build({libs!r})")
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
    edits = {**VARIANTS, **GRAM_VARIANTS}
    names = argv or list(edits)
    for name in names:
        make(name, edits[name])
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
    gen = torch.Generator(device=dev).manual_seed(0)
    stacks = {(m, d): torch.randn(m, d, device=dev, generator=gen)
              for m, d in GRAM_CASES}
    plains = {key: norm_agg.pair_gram_blocked_plain(x)
              for key, x in stacks.items()}
    rows = {}
    for name in names:
        _build.CSRC = OUT / name / "csrc"
        _build.BUILD_DIR = OUT / name / "lib"
        _build._LIBS.clear()
        row = {}
        if name in GRAM_VARIANTS:
            for (m, d), x in stacks.items():
                want = plains[(m, d)]
                try:
                    got = norm_agg.pair_gram_blocked(x)
                except RuntimeError:  # the launch refuses the shape: the
                    continue          # fold-2048 variant below 2048 columns
                err = float((got - want).abs().max() / want.abs().max())
                row[f"pair_gram_blocked {m}x{d}"] = C.device_profile(
                    lambda: norm_agg.pair_gram_blocked(x))[0]
                row[f"pair_gram_blocked {m}x{d} error"] = err
            rows[name] = row
            print(f"[variant {name}] device ms, error / largest entry: "
                  + ", ".join(f"{k} {v:.4g}" for k, v in row.items())
                  + f" [{card}]", flush=True)
            continue
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
