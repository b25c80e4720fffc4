#!/usr/bin/env python3
"""The bf16 LSTM backward (#8b), the bf16 T-tiled conv backward (#9c) and,
with --wide, the wide bf16 backwards (#9c wide, #10b wide), each beside
its twin, held to an fp64 evaluation of the same function, on the card:

    python3 -m vslnet_torch.bench.tc_bwd_fp64
    PYTHONPATH=<older tree> python3 vslnet_torch/bench/tc_bwd_fp64.py

The twins (`lstm_recurrence_bwd_plain`, `conv_block_bwd_plain`) compute
the JAX package's bf16 VJPs in fp32 with cuBLAS's sums; with
work=float64 the same functions keep their bf16 rounding points (#8b: the
dgates, h_prev; #9c: n, d, wp, g_p) and hold every other value in float64.
The fp64 functions are this file's tree's twins, loaded from its own
ops/kernels.py, whatever tree on PYTHONPATH the kernels come from, so that
a parent and a change are read against one evaluation. For each case of
bench/bf16_vjp.py's card_cases ("lstm", "conv_tiled") and the long paths'
shapes (#8b at path M's [192, 16, 128]; #9c at path M's [16, 192, 128]
and path L's [8, 1024, 128]), drop 0 and 0.2 for #9c, it prints
bf16_vjp's readings (a bf16 output's share of differing values and its
worst frame or row; an fp32 output's mean error over its mean magnitude)
of the kernel against the twin, the kernel against fp64 and the twin
against fp64, and bf16_vjp's verdict. One JSON line a case, with the
card's name and power limit.

    python3 -m vslnet_torch.bench.tc_bwd_fp64 --seeds 8 [--k8]

Only #8b at T = 128 and 192 ([T, 16, 512]), over 8 draws (seeds 100-107):
its chain makes one draw's shares vary by a third.

    python3 -m vslnet_torch.bench.tc_bwd_fp64 --k8

Adds to each #8b row the readings of a copy of csrc/lstm.cu whose step
product runs each k16 step as two m16n8k8 mma (8 products summed inside
the tensor core, not 16) added in fp32 (`kernel_k8`), built into
vslnet_torch/_build/bench/ and launched through the wrapper.

    python3 -m vslnet_torch.bench.tc_bwd_fp64 --wide

Only the wide bf16 backwards at `saturated`'s widths, bf16_vjp's card
cases ("conv_wide", "mha_wide": [256, 128, 1024] first, drop 0 and 0.2):
#9c wide's dx and dwp, #10b wide's dx (through which its attention's dq,
dk and dv show) and dwqkv, each of them and every other output read
against conv_block_bwd_plain and mha_block_bwd_plain at work=float64.

    python3 -m vslnet_torch.bench.tc_bwd_fp64 --wide --seeds 8

Only the wide backwards' small cases (WIDE_SEEDED: #9c wide at [32, 24,
1024], #10b wide at [2, 128, 256]), drop 0 and 0.2, over 8 draws (seeds
100-107), each row with its seed: a bf16 output's share of differing
values counts a few hundred flips there, so that one draw's ratio to a
parent's can stray by a quarter.

    python3 -m vslnet_torch.bench.tc_bwd_fp64 --block-bwd [--seeds 64]
    PYTHONPATH=<parent> python3 vslnet_torch/bench/tc_bwd_fp64.py --block-bwd > parent.jsonl
    python3 -m vslnet_torch.bench.tc_bwd_fp64 --block-bwd --against parent.jsonl

Only the bf16 block backwards over 64 draws (seeds 100-163; drop 0 on even
seeds, 0.2 on odd ones): #9b at the query stream's [16, 12, 128] and
#10b at [16, 128, 128] and T = 12, 8 heads, each output's mean error over
its mean magnitude against an fp64 evaluation of its function (this file's
tree's twin at float64), the kernel's and the twin's, with bf16_vjp's
verdict; --against as --fwd's (an older tree's whole-row conv wrappers
run through `_older_conv_wrappers`).

    python3 -m vslnet_torch.bench.tc_bwd_fp64 --fwd [--seeds 16] [--faults] [--kinds lstm,conv,mha]
    PYTHONPATH=<parent> python3 vslnet_torch/bench/tc_bwd_fp64.py --fwd > parent.jsonl
    python3 -m vslnet_torch.bench.tc_bwd_fp64 --fwd --against parent.jsonl

Only the bf16 forwards over 16 draws (seeds 100-115; --seeds sets the
count; --kinds a subset): "lstm", #1b's out and #7b's out and acts at [T,
16, 512], T = 128 and path M's 192 (--k8 adds the readings of a copy whose
k16 products are two m16n8k8 mma each, `kernel_k8`); "conv", #2c's out
at [16, 128, 128], path M's [16, 192, 128] and path L's [8, 1024, 128];
"mha", #3b's out at [16, 128, 128] and the query stream's [16, 12, 128],
8 heads (the blocks at drop 0 on even seeds, 0.2 on odd ones). Each
output's distance from an fp64 evaluation of the bf16-rounded function
(this file's tree's twin at float64; mean error over mean magnitude, at
the LSTM's valid positions: bench/bf16_vjp.py lstm_fwd_fp64,
block_fwd_read), the kernel's and the twin's, with bf16_vjp's verdict (the
LSTM's kernel within the twin's distance plus LSTM_FWD_FP64_SLACK; a
block's within BF16_FWD_TOL and BF16_FWD_SHARE_TOL of the twin and of
fp64). --faults adds, on the first draw of each shape, each of bf16_vjp's
planted faults of the tensor-core forwards (LSTM_FWD_FAULTS,
BLOCK_FWD_FAULT_EDITS) with its reading and whether the verdict refused
it. --against reads a parent's rows (the same command on the parent tree)
and prints, for each kernel, shape and output, the change's distance over
the parent's on each draw (range, geometric mean, draws within the ratio)
and the ratio of their means over the draws, held to 1.25 (ROADMAP C7's
rule, read on the means: a draw without a flip puts a tree within 1e-6 of
fp64, so one draw's ratio can read 0.05 or 40).
"""
import ctypes
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

LONG = {"lstm": [(192, 16, 128)], "conv_tiled": [(16, 192, 128), (8, 1024, 128)]}


def _own(relpath, name):
    """This tree's module at vslnet_torch/<relpath>, loaded on its own,
    whatever tree on PYTHONPATH its imports come from."""
    path = Path(__file__).resolve().parents[1] / relpath
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fp64_twins():
    """This tree's ops/kernels.py, loaded on its own: its twins take
    work=float64 (an older tree's may not)."""
    return _own("ops/kernels.py", "tc_bwd_fp64_kernels")


# the block forwards' shapes of --fwd: the main path's, path M's and path
# L's conv blocks; the MHA block at T = 128 and the query stream's 12
BLOCK_FWD_SHAPES = {"conv": [(16, 128, 128), (16, 192, 128), (8, 1024, 128)],
                    "mha": [(16, 128, 128, 8), (16, 12, 128, 8)]}


def fwd_rows(V, twins, dev, seeds, kinds=("lstm", "conv", "mha")):
    """(seed, shape, entry name, what, args, the fp64 readings {"kernel",
    "twin": {output: distance}}, the verdict) of each --fwd draw: seeds 100
    on; #1b and #7b at T = 128 and 192 (what: residuals), the block
    forwards at BLOCK_FWD_SHAPES (what: (kind, seeds, rate))."""
    for seed in range(100, 100 + seeds):
        for T in (128, 192) if "lstm" in kinds else ():
            args = V.lstm_fwd_inputs(dev, np.random.default_rng(seed), T, 16, 128)
            for name, residuals in (("lstm_recurrence_fwd_bf16", False),
                                    ("lstm_recurrence_fwd_res_bf16", True)):
                f = V.lstm_fwd_fp64(args, V.lstm_fwd_outputs(args, residuals),
                                    twins.lstm_recurrence_plain)
                yield (seed, (T, 16, 512), name, residuals, args, f,
                       V.lstm_fwd_fp64_verdict(f))
        for kind in ("conv", "mha"):
            if kind not in kinds:
                continue
            for shape in BLOCK_FWD_SHAPES[kind]:
                rate = 0.2 * (seed % 2)
                args, sd = V.block_fwd_inputs(dev, np.random.default_rng(seed), kind,
                                              shape, rate)
                r = V.block_fwd_read(kind, args, sd, rate, V.block_fwd(kind, args, sd, rate),
                                     twins)
                f = {"kernel": {"out": r["fp64"]["mean_rel"]},
                     "twin": {"out": r["twin_fp64"]["mean_rel"]}, "readings": r}
                yield (seed, shape, V.BLOCK_FWD_ENTRIES[kind], (kind, sd, rate), args, f,
                       V.block_fwd_verdict(r))


def fwd_main(argv, smi, dev):
    """The --fwd rows (module docstring). The readings come from this
    tree's bench/bf16_vjp.py, loaded on its own, so that a parent's
    kernels are read as this tree's are."""
    import torch

    from vslnet_torch.bench.common import build_copy, library_with, with_library

    V = _own("bench/bf16_vjp.py", "tc_fwd_bf16_vjp")
    twins = fp64_twins()
    seeds = int(argv[argv.index("--seeds") + 1]) if "--seeds" in argv else 16
    kinds = (argv[argv.index("--kinds") + 1].split(",") if "--kinds" in argv
             else ("lstm", "conv", "mha"))
    if "--against" in argv:
        return against(argv[argv.index("--against") + 1],
                       fwd_rows(V, twins, dev, seeds, kinds), V.LSTM_FWD_FP64_RATIO)
    libs = None
    if "--faults" in argv:
        libs = {"lstm": V.lstm_fwd_fault_libraries() if "lstm" in kinds else None,
                **{k: V.block_fwd_fault_libraries(k) for k in ("conv", "mha") if k in kinds}}
    k8 = None
    if "--k8" in argv:
        k8 = library_with(build_copy("lstm_fwd_k8", fwd_k8_source(
            (V.K.CSRC / "lstm.cu").read_text()).replace('extern "C" int vsl_', 'extern "C" int fault_')),
            V.LSTM_FWD_ENTRIES)
    for seed, shape, name, what, args, f, (ok, why) in fwd_rows(V, twins, dev, seeds, kinds):
        lstm = name.startswith("lstm")
        row = {"bench": "tc_bwd_fp64", "card": smi, "kernel": name, "shape": list(shape),
               "seed": seed, "fp64": f, "verdict": ok, "why": why}
        if not lstm:
            row["drop_rate"] = what[2]
        if k8 is not None and lstm:
            got = with_library(k8, lambda: V.lstm_fwd_outputs(args, what))
            row["kernel_k8"] = V.lstm_fwd_fp64(args, got, twins.lstm_recurrence_plain)["kernel"]
        if libs is not None and seed == 100 and lstm:
            row["faults"] = {}
            for fault in V.LSTM_FWD_FAULTS:
                ff = V.lstm_fwd_fp64(args, V.lstm_fwd_fault(args, fault, what, libs["lstm"]),
                                     twins.lstm_recurrence_plain)
                row["faults"][fault] = {"kernel": ff["kernel"],
                                        "refused": not V.lstm_fwd_fp64_verdict(ff)[0]}
        if libs is not None and seed == 101 and not lstm:  # drop 0.2
            kind, sd, rate = what
            row["faults"] = {}
            for fault, lib in libs[kind].items():
                rf = V.block_fwd_read(kind, args, sd, rate,
                                      V.block_fwd_fault(kind, args, sd, rate, lib), twins)
                row["faults"][fault] = {"fp64": rf["fp64"],
                                        "refused": not V.block_fwd_verdict(rf)[0]}
        print(json.dumps(row), flush=True)
        torch.cuda.synchronize()
    return 0


# the bf16 block backwards of --block-bwd: #9b at the query stream's [16,
# 12, 128], #10b at [16, 128, 128] and the query stream's T = 12, 8 heads
BLOCK_BWD_SHAPES = {"conv": [(16, 12, 128)], "mha": [(16, 128, 128, 8), (16, 12, 128, 8)]}


def _older_conv_wrappers(K):
    """An older tree's whole-row conv wrappers under this tree's calls: its
    bf16 forward saves no residuals, its backward replays the forward."""
    import inspect

    if "residuals" in inspect.signature(K.launch_conv_block_fwd).parameters:
        return
    fwd, bwd = K.launch_conv_block_fwd, K.launch_conv_block_bwd
    K.launch_conv_block_fwd = lambda *a: (fwd(*a[:8]), None, None) if a[8:9] == (True,) \
        else fwd(*a)
    K.launch_conv_block_bwd = lambda *a: bwd(*a[:9])


def block_bwd_rows(V, twins, dev, seeds):
    """(seed, shape, entry name, drop rate, the fp64 readings {"kernel",
    "twin": {output: mean error over mean magnitude}}, the verdict) of each
    --block-bwd draw: seeds 100 on, drop 0 on even seeds and 0.2 on odd
    ones, BLOCK_BWD_SHAPES."""
    import torch

    _older_conv_wrappers(V.K)
    for seed in range(100, 100 + seeds):
        rate = 0.2 if seed % 2 else 0.0
        for kind, shapes in BLOCK_BWD_SHAPES.items():
            for shape in shapes:
                rng = np.random.default_rng(seed)
                case = (V.conv_case(dev, rng, *shape, rate) if kind == "conv"
                        else V.mha_case(dev, rng, *shape, rate))
                plain = (twins.conv_block_bwd_plain if kind == "conv"
                         else twins.mha_block_bwd_plain)
                ref = [t.detach() for t in plain(*case.args, work=torch.float64)]
                f = {}
                for who, outs in (("kernel", case.kernel()), ("twin", case.twin())):
                    f[who] = {n: V.mean_rel(o.detach(), r, torch.ones_like(r, dtype=torch.bool))
                              for n, o, r in zip(case.names, outs, ref)}
                yield seed, shape, case.name, rate, f, V.verdict(case, V.read(case))


def block_bwd_main(argv, smi, dev):
    """The --block-bwd rows (module docstring), from this tree's
    bench/bf16_vjp.py loaded on its own, as --fwd's."""
    import torch

    V = _own("bench/bf16_vjp.py", "tc_block_bwd_bf16_vjp")
    twins = fp64_twins()
    seeds = int(argv[argv.index("--seeds") + 1]) if "--seeds" in argv else 64
    rows = block_bwd_rows(V, twins, dev, seeds)
    if "--against" in argv:
        return against(argv[argv.index("--against") + 1],
                       ((seed, shape, name, None, None, f, None)
                        for seed, shape, name, _, f, _ in rows), 1.25)
    for seed, shape, name, rate, f, (ok, why) in rows:
        print(json.dumps({"bench": "tc_bwd_fp64", "card": smi, "kernel": name,
                          "shape": list(shape), "seed": seed, "drop_rate": rate, "fp64": f,
                          "verdict": ok, "why": why}), flush=True)
        torch.cuda.synchronize()
    return 0


def against(path, rows, ratio):
    """The --against summary of this tree's fwd_rows over a parent's from
    `path` (JSON lines of --fwd): exit 1 where no draw matches."""
    parent = {}
    for line in Path(path).read_text().splitlines():
        row = json.loads(line) if line.startswith("{") else {}
        if row.get("bench") == "tc_bwd_fp64" and "fp64" in row:
            parent[row["kernel"], tuple(row["shape"]), row["seed"]] = row["fp64"]["kernel"]
    dists = {}  # (kernel, shape, output): [(change, parent)] over the draws
    for seed, shape, name, _, _, f, _ in rows:
        for n, k in f["kernel"].items():
            if (name, tuple(shape), seed) in parent:
                dists.setdefault((name, tuple(shape), n), []).append(
                    (k, parent[name, tuple(shape), seed][n]))
    for (name, shape, n), ds in sorted(dists.items()):
        rs = [k / p if p else (1.0 if k == p else float("inf")) for k, p in ds]
        mean_ratio = float(np.mean([k for k, _ in ds]) / np.mean([p for _, p in ds]))
        print(json.dumps({"bench": "tc_bwd_fp64", "against": path, "kernel": name,
                          "shape": list(shape), "T": shape[0] if name.startswith("lstm")
                          else shape[1], "output": n, "draws": len(rs), "min": min(rs),
                          "max": max(rs), "geometric_mean": float(np.exp(np.mean(np.log(rs)))),
                          "mean_ratio": mean_ratio, "within": sum(r <= ratio for r in rs),
                          "rule_met": mean_ratio <= ratio}), flush=True)
    return 0 if dists else 1


K16_STEP = "          vsl::mma16(c[ks][mt], a[mt][ks], b[0], b[1]);\n"
K8_STEP = ("          {\n            float h[4] = {0.f, 0.f, 0.f, 0.f};\n"
           "            vsl::mma8(c[ks][mt], a[mt][ks][0], a[mt][ks][1], b[0]);\n"
           "            vsl::mma8(h, a[mt][ks][2], a[mt][ks][3], b[1]);\n"
           "            for (int e = 0; e < 4; ++e) c[ks][mt][e] += h[e];\n          }\n")


def k8_library():
    """The kernel library with the bf16 LSTM backward taken from a copy of
    lstm.cu whose step product is two m16n8k8 mma a k16 step."""
    from vslnet_torch.bench.common import build_copy
    from vslnet_torch.ops import kernels as K

    src = (K.CSRC / "lstm.cu").read_text()
    if src.count(K16_STEP) != 1:
        raise RuntimeError("the k16 step is not found once in lstm.cu")
    copy = build_copy("lstm_k8", src.replace(K16_STEP, K8_STEP).replace(
        'extern "C" int vsl_', 'extern "C" int k8_'))
    fn = copy.k8_lstm_recurrence_bwd_bf16
    fn.argtypes = K._SIGNATURES["vsl_lstm_recurrence_bwd_bf16"]
    fn.restype = ctypes.c_int
    main = K._library()

    class Lib:
        def __getattr__(self, name):
            if name == "vsl_lstm_recurrence_bwd_bf16":
                return fn
            return getattr(main, name)
    return Lib()


# the bf16 forward's k16 product (csrc/lstm.cu fwd_tc_gates) as two
# m16n8k8 mma added in fp32 (8 products summed inside the tensor core, not
# 16): a copy --fwd --k8 reads and lstm_plans --fwd times
FWD_K16_STEP = "      vsl::mma16(d[ks + j], a[ks + j], b[2 * j], b[2 * j + 1]);\n"
FWD_K8_STEP = ("      {\n        float h8[4] = {0.f, 0.f, 0.f, 0.f};\n"
               "        vsl::mma8(d[ks + j], a[ks + j][0], a[ks + j][1], b[2 * j]);\n"
               "        vsl::mma8(h8, a[ks + j][2], a[ks + j][3], b[2 * j + 1]);\n"
               "        for (int e = 0; e < 4; ++e) d[ks + j][e] += h8[e];\n      }\n")


def fwd_k8_source(src):
    """lstm.cu with the bf16 forward's k16 products as FWD_K8_STEP."""
    if src.count(FWD_K16_STEP) != 1:
        raise RuntimeError("the forward's k16 step is not found once in lstm.cu")
    return src.replace(FWD_K16_STEP, FWD_K8_STEP)


WIDE = ("conv_wide", "mha_wide")
# (kind, shape) of the wide cases read over draws: [B, T, D] (and heads)
WIDE_SEEDED = [("conv_wide", (32, 24, 1024)), ("mha_wide", (2, 128, 256, 2))]


def cases(dev, seeds=0, wide=False):
    """(kind, case, seed) of the card cases and the long paths' shapes;
    with `seeds`, #8b at T = 128 and 192 over that many draws instead; with
    `wide`, the wide kernels' card cases instead, or with both, WIDE_SEEDED
    over the draws (seed None where the case is drawn from a shared
    generator)."""
    from vslnet_torch.bench import bf16_vjp as V

    if wide and seeds:
        for seed in range(100, 100 + seeds):
            for kind, shape in WIDE_SEEDED:
                for rate in (0.0, 0.2):
                    rng = np.random.default_rng(seed)
                    yield kind, (V.conv_case(dev, rng, *shape, rate, wide=True)
                                 if kind == "conv_wide" else
                                 V.mha_case(dev, rng, *shape, rate)), seed
        return
    if wide:
        for kind in WIDE:
            for case in V.card_cases(dev, kind):
                yield kind, case, None
        return
    if seeds:
        for seed in range(100, 100 + seeds):
            for T in (128, 192):
                yield "lstm", V.lstm_case(dev, np.random.default_rng(seed), T, 16, 128), seed
        return
    for kind in ("lstm", "conv_tiled"):
        for case in V.card_cases(dev, kind):
            yield kind, case, None
        rng = np.random.default_rng(37)
        for shape in LONG[kind]:
            if kind == "lstm":
                yield kind, V.lstm_case(dev, rng, *shape), None
            else:
                for rate in (0.0, 0.2):
                    yield kind, V.conv_case(dev, rng, *shape, rate, True), None


def main():
    import torch

    from vslnet_torch.bench import bf16_vjp as V
    from vslnet_torch.bench.common import card

    if not torch.cuda.is_available():
        print("tc_bwd_fp64: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = card()
    if "--fwd" in sys.argv[1:]:
        return fwd_main(sys.argv[1:], smi, dev)
    if "--block-bwd" in sys.argv[1:]:
        return block_bwd_main(sys.argv[1:], smi, dev)
    twins = fp64_twins()
    fp64 = {"lstm": twins.lstm_recurrence_bwd_plain, "conv_tiled": twins.conv_block_bwd_plain,
            "conv_wide": twins.conv_block_bwd_plain, "mha_wide": twins.mha_block_bwd_plain}
    argv = sys.argv[1:]
    k8 = k8_library() if "--k8" in argv else None
    seeds = int(argv[argv.index("--seeds") + 1]) if "--seeds" in argv else 0
    for kind, case, seed in cases(dev, seeds, "--wide" in argv):
        kern = [t.clone() for t in case.kernel()]
        twin = [t.detach() for t in case.twin()]
        ref = [t.detach() for t in fp64[kind](*case.args, work=torch.float64)]
        ok, why = V.verdict(case, V.read(case))
        row = {"bench": "tc_bwd_fp64", "card": smi, "kernel": case.name,
               "shape": list(case.shape), "seed": seed, "verdict": ok, "why": why}
        if kind in ("conv_tiled", "conv_wide"):
            row["drop_rate"] = case.args[7]
        elif kind == "mha_wide":
            row["drop_rate"] = case.args[10]
        k_t, k_f, t_f = (V.reading(case, a, b) for a, b in
                         ((kern, twin), (kern, ref), (twin, ref)))
        for n in case.names:
            row[n] = {"kernel_vs_twin": k_t[n], "kernel_vs_fp64": k_f[n],
                      "twin_vs_fp64": t_f[n]}
        if k8 is not None and kind == "lstm":
            from vslnet_torch.ops import kernels as K

            main, K._LIB = K._LIB, k8
            try:
                got = [t.clone() for t in case.kernel()]
            finally:
                K._LIB = main
            r_t, r_f = V.reading(case, got, twin), V.reading(case, got, ref)
            for n in case.names:
                row[n].update(kernel_k8_vs_twin=r_t[n], kernel_k8_vs_fp64=r_f[n])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
