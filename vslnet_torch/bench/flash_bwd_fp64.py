#!/usr/bin/env python3
"""The bf16 flash backward (#14b) and its twin, each held to an fp64
evaluation of the same function, on the card:

    python3 -m vslnet_torch.bench.flash_bwd_fp64
    PYTHONPATH=<older tree> python3 vslnet_torch/bench/flash_bwd_fp64.py

The twin (`flash_attention_bwd_plain`) computes the function in fp32 with
cuBLAS's sums; `fp64` below computes it with the same bf16 rounding points
(qs, drop(P), dS) and every other value in float64. A kernel whose sums
run in another order than cuBLAS's (the tensor cores' mma) rounds dS the
other way on a few of the values that lie near a bf16 boundary, and so
does the twin against fp64: this prints, for each case of
bench/bf16_vjp.py's `attention_case` over T = 100-2100, head dims 8-64,
drop 0 and 0.2, at B = 2 and B = 8, the share of each bf16 output (dq, dk,
dv) that differs and the largest such share in one frame of dq, for the
kernel against the twin (what bench/bf16_vjp.py holds), the kernel
against fp64 and the twin against fp64, and bf16_vjp's verdict. One JSON
line a case, with the card's name and power limit.
"""
import json
import math
import sys

import numpy as np

T_GRID = (100, 300, 1000, 1024, 1152, 2100)
HEAD_DIMS = (8, 16, 32, 64)


def fp64(q, k, v, mask, n_heads, seeds, drop_rate, out, lse, g):
    """flash_attention_bwd_plain's function with its bf16 rounding points,
    every other value in float64: (dq, dk, dv) [B, T, D] float64."""
    import torch

    from vslnet_torch.ops import kernels as K

    f64, bf = torch.float64, torch.bfloat16

    def rnd(t):
        return t.to(bf).to(f64)

    B, T, D = q.shape
    hd = D // n_heads

    def heads(t):
        return t.to(f64).reshape(B, T, n_heads, hd).transpose(1, 2)

    def merge(t):
        return t.transpose(1, 2).reshape(B, T, D)

    scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32))
    qs = rnd(heads(q) * scale)
    kh, vh, gh = heads(k), heads(v), heads(g)
    delta = (gh * heads(out)).sum(-1, keepdim=True)
    p = torch.exp(qs @ kh.transpose(-1, -2)
                  + ((1.0 - mask.to(f64)) * -1e30).reshape(B, 1, 1, T)
                  - lse.to(f64)[..., None])
    p = torch.where((mask != 0).any(-1).reshape(B, 1, 1, 1), p, 1.0 / T)
    keep = K._keep_bits(seeds, drop_rate, n_heads, T)

    def drop(a):
        return a if keep is None else torch.where(
            keep, a * (1.0 / (1.0 - drop_rate)), 0.0)

    dv = rnd(drop(p)).transpose(-1, -2) @ gh
    ds = rnd(p * (drop(gh @ vh.transpose(-1, -2)) - delta))
    return (merge((ds @ kh) * scale), merge(ds.transpose(-1, -2) @ qs),
            merge(dv))


def shares(a, b):
    """(share of differing bf16 values, the largest share in one frame)."""
    import torch

    d = a.to(torch.bfloat16) != b.to(torch.bfloat16)
    return float(d.float().mean()), float(d.float().mean(dim=(0, 2)).max())


def main():
    import torch

    from vslnet_torch.bench import bf16_vjp as V
    from vslnet_torch.bench.common import card

    if not torch.cuda.is_available():
        print("flash_bwd_fp64: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = card()
    for B in (2, 8):
        for T in T_GRID:
            for hd in HEAD_DIMS:
                for rate in (0.0, 0.2):
                    rng = np.random.default_rng(42)
                    case = V.attention_case(dev, rng, B, T, 128, 128 // hd,
                                            rate, True)
                    kern = [t.clone() for t in case.kernel()]
                    twin, ref = case.twin(), fp64(*case.args)
                    ok, why = V.verdict(case, V.read(case))
                    row = {"bench": "flash_bwd_fp64", "card": smi,
                           "shape": [B, T, 128], "heads": 128 // hd,
                           "drop_rate": rate, "verdict": ok, "why": why}
                    for n, a, b, r in zip(V.ATTN_NAMES, kern, twin, ref):
                        row[n] = {"kernel_vs_twin": shares(a, b),
                                  "kernel_vs_fp64": shares(a, r),
                                  "twin_vs_fp64": shares(b, r)}
                    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
