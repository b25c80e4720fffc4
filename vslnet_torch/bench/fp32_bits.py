#!/usr/bin/env python3
"""The sha1 of what every fp32 kernel of the port returns, on seeded inputs
on the card, so that two trees of the port can be held bit for bit.

    PYTHONPATH=<older tree> python3 vslnet_torch/bench/fp32_bits.py > old.json
    PYTHONPATH=<this tree> python3 vslnet_torch/bench/fp32_bits.py \\
        --against old.json

Run by path, the script imports the `vslnet_torch` that PYTHONPATH names
(which builds its own kernels) and calls only wrappers that the port has
had since all 14 kernels were ported, with their fp32 signatures. Each
case is one wrapper call, or the gradients of sum(out * g) through the
wrapper's autograd Function: the LSTM lean forward (#1) and the forward
with residuals and the backward (#7, #8) at [128, 16, 512]; the conv block
forward whole-row at the query stream's [16, 12, 128] and T-tiled at [16,
128, 128], the backward both ways (#2, #9); the MHA block forward and
backward (#3, #10) at [16, 128, 128] and [16, 12, 128], 8 heads; the
whole-T attention forward and backward (#11, #12) at [16, 192, 128]; the
flash ones (#13, #14) at [8, 1024, 128]; the span decode (#4), CQA (#5) and
the highlight gate (#6) at the served shapes. Dropout at 0 (served) and
0.2 (trained), where the kernel takes it. Prints one JSON line:
{"card", "torch", "package" (the imported package's directory), "sha1":
{case: digest}}; with --against, also the cases whose digests differ from
that file's, and exits 1 if any does.
"""
import argparse
import hashlib
import json
import math
import os
import subprocess
import sys

import numpy as np

SEED = 20260101
B, T, D, H, L, KS, HEADS, W = 16, 128, 128, 128, 4, 7, 8, 12


def digest(tensors):
    """sha1 of the tensors' bytes: equal digests, equal bits."""
    return hashlib.sha1(b"".join(
        t.detach().contiguous().cpu().numpy().tobytes()
        for t in tensors)).hexdigest()


def flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def grads(fn, args, n_grad, rng, t):
    """The gradients of sum(out * g) with respect to the first n_grad
    args, g seeded."""
    import torch

    leaves = [a.detach().clone().requires_grad_(i < n_grad)
              for i, a in enumerate(args)]
    out = fn(*leaves)
    g = t(rng.standard_normal(tuple(out.shape)))
    return torch.autograd.grad((out * g).sum(), leaves[:n_grad])


def cases():
    """{name: a thunk returning the tensors to hash}."""
    import torch

    from vslnet_torch.ops import kernels as K

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def seeds(n):
        return t(rng.integers(0, 1 << 23, (n, 1)))

    def ragged(n, T_, empty=False):
        lens = np.concatenate([[T_, 1], rng.integers(1, T_ + 1, n - 2)])
        if empty:
            lens[1] = 0
        return lens

    out = {}
    lens = ragged(B, T)
    x_proj = t(rng.standard_normal((T, B, 4 * H)))
    k_h = t(rng.standard_normal((H, 4 * H)) / math.sqrt(H))
    valid = t(np.arange(T)[:, None] < lens[None, :])
    lstm = (x_proj, k_h, valid)
    out["lstm_fwd"] = lambda: K.launch_lstm_fwd(*lstm)
    out["lstm_fwd_res"] = lambda: K.launch_lstm_fwd_res(*lstm)
    out["lstm_grads"] = lambda: grads(K.fused_lstm_recurrence, lstm, 2, rng,
                                      t)

    def conv_inputs(T_):
        return [t(rng.standard_normal((B, T_, D))),
                t(1 + 0.1 * rng.standard_normal((L, D))),
                t(0.1 * rng.standard_normal((L, D))),
                t(rng.standard_normal((L, KS, D)) / math.sqrt(KS)),
                t(rng.standard_normal((L, D, D)) / math.sqrt(D)),
                t(0.1 * rng.standard_normal((L, D)))]

    for T_ in (W, T):
        conv = conv_inputs(T_)
        s = seeds(B)
        for rate in (0.0, 0.2):
            kw = {"seeds": s, "drop_rate": rate}
            name = "conv_T%d_rate%g" % (T_, rate)
            out[name + "_fwd"] = (
                lambda c=conv, kw=kw: K.launch_conv_block_fwd(*c, **kw))
            out[name + "_fwd_tiled"] = (
                lambda c=conv, kw=kw: K.launch_conv_block_fwd_tiled(*c, **kw))
            out[name + "_grads"] = (lambda c=conv, kw=kw: grads(
                lambda *a: K.fused_conv_block(*a, **kw), c, 6, rng, t))

    def mha_inputs(T_):
        lens_ = ragged(B, T_, empty=True)
        return [t(rng.standard_normal((B, T_, D))),
                t(np.arange(T_)[None, :] < lens_[:, None]),
                t(1 + 0.1 * rng.standard_normal((2, D))),
                t(0.1 * rng.standard_normal((2, D))),
                t(rng.standard_normal((D, 3 * D)) / math.sqrt(D)),
                t(0.1 * rng.standard_normal(3 * D)),
                t(rng.standard_normal((D, D)) / math.sqrt(D)),
                t(0.1 * rng.standard_normal(D))]

    for T_ in (T, W):
        mha = mha_inputs(T_)
        s = seeds(B)
        for rate in (0.0, 0.2):
            kw = {"seeds": s, "drop_rate": rate}
            name = "mha_block_T%d_rate%g" % (T_, rate)
            out[name + "_fwd"] = (lambda m=mha, kw=kw: K.launch_mha_block_fwd(
                *m, HEADS, **kw))
            out[name + "_grads"] = (lambda m=mha, kw=kw: grads(
                lambda *a: K.fused_mha_block(a[0], a[-1], *a[1:-1], HEADS,
                                             **kw),
                [m[0], *m[2:], m[1]], 7, rng, t))

    def attention_inputs(B_, T_):
        lens_ = ragged(B_, T_)
        return [t(rng.standard_normal((B_, T_, D))) for _ in range(3)] + [
            t(np.arange(T_)[None, :] < lens_[:, None])]

    for B_, T_, launch in ((B, 192, K.launch_mha_fwd),
                           (8, 1024, K.launch_flash_mha_fwd)):
        att = attention_inputs(B_, T_)
        s = seeds(B_)
        for rate in (0.0, 0.2):
            kw = {"seeds": s, "drop_rate": rate}
            name = "attention_T%d_rate%g" % (T_, rate)
            out[name + "_fwd"] = (lambda a=att, kw=kw, f=launch: f(
                *a, HEADS, **kw))
            out[name + "_grads"] = (lambda a=att, kw=kw: grads(
                lambda q, k, v, m: K.fused_mha(q, k, v, m, HEADS, **kw),
                a, 3, rng, t))

    mask = t(np.arange(T)[None, :] < lens[:, None])
    logits = [t(rng.standard_normal((B, T)) * 3) * mask + (1 - mask) * -1e30
              for _ in range(2)]
    out["span_decode"] = lambda: K.fused_span_decode(*logits)
    q_lens = np.concatenate([[W, 0], rng.integers(1, W + 1, B - 2)])
    cqa = [t(rng.standard_normal((B, T, D))), t(rng.standard_normal((B, W, D))),
           mask, t(np.arange(W)[None, :] < q_lens[:, None]),
           *[t(rng.standard_normal(D) / math.sqrt(D)) for _ in range(3)]]
    out["cqa_concat"] = lambda: K.fused_cqa_concat(*cqa)
    gate = [t(rng.standard_normal((B, T, D))),
            t(rng.standard_normal(D) / math.sqrt(D)),
            t(0.1 * rng.standard_normal(1)), mask]
    out["highlight_gate"] = lambda: K.fused_highlight_gate(*gate)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", help="a JSON line this script printed "
                        "for another tree")
    args = parser.parse_args(argv)
    import torch

    import vslnet_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        sys.exit("fp32_bits: no CUDA device")
    sha1 = {name: digest(flat(fn())) for name, fn in cases().items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    row = {"card": card, "torch": torch.__version__,
           "package": os.path.dirname(vslnet_torch.__file__), "sha1": sha1}
    if args.against:
        with open(args.against) as f:
            other = json.loads(f.read().strip().splitlines()[-1])["sha1"]
        row["differ"] = sorted(n for n in sha1 if other.get(n) != sha1[n])
        row["cases"] = len(sha1)
    print(json.dumps(row), flush=True)
    if row.get("differ"):
        sys.exit(1)


if __name__ == "__main__":
    main()
