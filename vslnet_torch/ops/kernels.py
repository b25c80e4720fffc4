"""Hand-written CUDA kernels of the port, with their plain PyTorch versions
and launch counters. The counterpart of the JAX package's
ops/pallas_kernels.py.

Each wrapper below takes the plain version for tensors on the CPU (the
tests) and launches its kernel for tensors on a CUDA device; there it
raises on anything the kernel does not take and never falls back. The
plain versions also serve the model under `use_pallas=off`. The LSTM
recurrence, the conv block, the MHA block and attention have backward
kernels too: on the card their wrappers go through a
`torch.autograd.Function` (`FusedLSTMRecurrence`, `FusedConvBlock`,
`FusedConvBlockTiled`, `FusedMHABlock`, `FusedMHA`, `FusedFlashMHA`), on
the CPU through torch's autograd of the plain versions. The `launch_*`
functions are the kernels alone, for CUDA tensors only: the autograd
Functions call them, and chip_smoke.py times them.

Which kernels a block takes on the card depends on its shape, by the
port's own gates (`conv_route`, `mha_route`, `attention_route`): the
whole-row conv block kernels for rows shorter than the measured crossovers
(24 frames when serving, 48 when training) and the T-tiled ones above;
the MHA block kernels up to T = 145 at D = 128, above that the block's
PyTorch ops around `fused_mha`, whose whole-T kernels take T up to 209 at
head dim 16 and its flash kernels any longer T.

The kernels (csrc/*.cu, sm_90a, fp32) are compiled with nvcc into one
shared library with a plain C interface, one nvcc process per source, all
started together, at the first launch (or by `build_library`), into
vslnet_torch/_build/, and bound with ctypes. Nothing is built at import.

Dropout inside the blocks is the JAX package's counter hash (`hash_bits`,
`mha_hash_bits`; csrc/hash.cuh): a murmur3 finalizer over (row, col,
seed, salt), so the keep masks of the kernels, their plain versions and
the TPU kernels are equal bit for bit, and a backward regenerates them
from the per-row seeds.
"""
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vslnet_torch.ops.masking import mask_logits

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# shared memory one block may use on Hopper (232,448 bytes of the SM's 256 KB)
MAX_SMEM_BYTES = 232448
# streaming multiprocessors of an H100 SXM: the split-K weight products aim
# to fill them
N_SMS = 132

# launches of each kernel since the last reset_launches(); a wrapper adds one
# where it launches its kernel and nowhere else
LAUNCHES = {"lstm_recurrence_fwd": 0, "lstm_recurrence_fwd_res": 0,
            "lstm_recurrence_bwd": 0, "conv_block_fwd": 0, "conv_block_bwd": 0,
            "mha_block_fwd": 0, "mha_block_bwd": 0, "cqa_concat_fwd": 0,
            "highlight_gate_fwd": 0, "span_decode": 0,
            "conv_block_fwd_tiled": 0, "conv_block_bwd_tiled": 0,
            "mha_fwd": 0, "mha_bwd": 0, "flash_mha_fwd": 0, "flash_mha_bwd": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --- build and load ----------------------------------------------------------

_LIB = None
_LIB_LOCK = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_DROP = [_U, _F]  # dropout threshold and scale, after the seeds pointer
_SIGNATURES = {
    "vsl_lstm_recurrence_fwd": [_P] * 4 + [_I] * 7 + [_P],
    "vsl_lstm_recurrence_fwd_res": [_P] * 8 + [_I] * 7 + [_P],
    "vsl_lstm_recurrence_bwd": [_P] * 10 + [_I] * 8 + [_P],
    "vsl_conv_block_fwd": [_P] * 7 + _DROP + [_P] + [_I] * 7 + [_P],
    "vsl_conv_block_bwd": [_P] * 8 + _DROP + [_P] * 8 + [_I] * 8 + [_P],
    "vsl_mha_block_fwd": [_P] * 9 + _DROP + [_P] * 3 + [_I] * 7 + [_P],
    "vsl_mha_block_bwd": [_P] * 7 + _DROP + [_P] * 15 + [_I] * 8 + [_P],
    "vsl_cqa_concat_fwd": [_P] * 10 + [_I] * 6 + [_P],
    "vsl_highlight_gate_fwd": [_P] * 6 + [_I] * 2 + [_P],
    "vsl_span_decode": [_P] * 4 + [_I] * 2 + [_P],
    "vsl_conv_block_fwd_tiled": [_P] * 7 + _DROP + [_P] * 2 + [_I] * 8 + [_P],
    "vsl_conv_block_bwd_tiled": [_P] * 9 + _DROP + [_P] * 9 + [_I] * 9 + [_P],
    "vsl_mha_fwd": [_P] * 5 + _DROP + [_P] + [_I] * 5 + [_P],
    "vsl_mha_bwd": [_P] * 5 + _DROP + [_P] * 5 + [_I] * 6 + [_P],
    "vsl_flash_mha_fwd": [_P] * 5 + _DROP + [_P] * 2 + [_I] * 5 + [_P],
    "vsl_flash_mha_bwd": [_P] * 5 + _DROP + [_P] * 8 + [_I] * 4 + [_P],
}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path():
    """Where the library of the current sources lives: the build directory
    is keyed by a hash of every source and the flags, so an edit rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libvslnet_kernels.so"


def build_library():
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link them
    into one shared library. Returns (path, seconds, compiler log); the log
    holds ptxas's registers, shared memory and spills per kernel."""
    path = library_path()
    if path.exists():
        return path, 0.0, ""
    t0 = time.perf_counter()
    nvcc = _nvcc()
    path.parent.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="build-", dir=path.parent))
    procs = []
    for src in _sources():
        obj = work / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append("== %s\n%s" % (src.name, out))
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed on %s:\n%s"
                           % (", ".join(failed), "\n".join(log)))
    tmp_lib = work / path.name
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o",
         str(tmp_lib)] + [str(o) for _, o, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n" + link.stdout)
    os.replace(tmp_lib, path)  # atomic: concurrent builders never see half a file
    shutil.rmtree(work, ignore_errors=True)
    return path, time.perf_counter() - t0, "\n".join(log)


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            path, _, _ = build_library()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.vsl_error_string.argtypes = [ctypes.c_int]
            lib.vsl_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _launch(name, *args):
    lib = _library()
    stream = torch.cuda.current_stream().cuda_stream
    code = getattr(lib, "vsl_" + name)(*args, stream)
    if code != 0:
        raise RuntimeError("CUDA kernel %s failed to launch: %s (%d)" % (
            name, lib.vsl_error_string(code).decode(), code))
    LAUNCHES[name] += 1


def _on_cuda(name, *tensors):
    """True for CUDA tensors, False for CPU tensors; raises on a mix or on
    another device type."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types != {"cuda"}:
        raise ValueError("%s: tensors must all be on the CPU or all on one "
                         "CUDA device, got %s" % (name, sorted(types)))
    return True


def _require_cuda(name, *tensors):
    if not _on_cuda(name, *tensors):
        raise ValueError("%s: the kernel takes CUDA tensors only" % name)


def _check(name, t, shape):
    if t.dtype != torch.float32:
        raise TypeError("%s: expected float32, got %s" % (name, t.dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s: expected shape %s, got %s"
                         % (name, tuple(shape), tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s: tensor must be contiguous" % name)


def _dropout_args(name, seeds, drop_rate, B):
    """(seeds pointer or None, threshold, scale) of a kernel's dropout:
    off at drop_rate 0; above it the per-row seeds [B, 1] are required."""
    if not drop_rate > 0.0:
        return None, 0, 1.0
    if not drop_rate < 1.0:
        raise ValueError("%s: drop_rate must be below 1, got %r"
                         % (name, drop_rate))
    if seeds is None:
        raise ValueError("%s: drop_rate > 0 needs per-row seeds [B, 1]" % name)
    _check(name, seeds, (B, 1))
    return seeds.data_ptr(), drop_threshold(drop_rate), 1.0 / (1.0 - drop_rate)


def _wgrad_splits(Z, M, N, K, waves=1):
    """Chunks of the K rows of a split-K weight product (common.cuh wgrad):
    enough 64 x 64-tile blocks to fill the SMs `waves` times, at least 64
    rows a chunk."""
    tiles = Z * -(-M // 64) * -(-N // 64)
    return max(1, min(-(-waves * N_SMS // tiles), K // 64))


def _empty(device, *shape):
    return torch.empty(*shape, device=device, dtype=torch.float32)


# --- counter-hash dropout --------------------------------------------------------
# Replaces vslnet_tpu/ops/pallas_kernels.py:_hash_bits, _mha_hash_bits and
# _drop32 (their device twin is csrc/hash.cuh). uint32 arithmetic is done
# in int64 and cut to 32 bits; each product is split so that it never
# leaves int64.

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _counter_hash(seeds, salt_term, rows, cols):
    """[R, rows, cols] int64 bits: the murmur3 finalizer over (i, j, seed,
    salt) for each of the R seeds."""
    seeds = torch.as_tensor(seeds).reshape(-1, 1, 1).to(torch.int64)
    i = torch.arange(rows, dtype=torch.int64, device=seeds.device)[:, None]
    j = torch.arange(cols, dtype=torch.int64, device=seeds.device)[None, :]
    x = _mul32(i, 0x9E3779B9) ^ _mul32(j, 0x85EBCA6B)
    x = x ^ ((_mul32(seeds, 2654435761) + salt_term) & _M32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_bits(seeds, salt, shape):
    """Bits of a block site (`_hash_bits`): seeds [R] (or [R, 1]) holding
    integers, salt, shape (A, B) -> [R, A, B] int64 in [0, 2^32)."""
    return _counter_hash(seeds, (0x94D049BB * (salt + 1)) & _M32, *shape)


def mha_hash_bits(seeds, head, T):
    """Bits of head `head`'s [T, T] probability tile (`_mha_hash_bits`)."""
    return _counter_hash(seeds, (0x27D4EB2F * (head + 1)) & _M32, T, T)


def drop_threshold(rate):
    """Keep an element iff its bits are at least this (as the JAX package)."""
    return min(int(rate * 4294967296.0), 4294967295)


def _drop_bits(a, bits, rate):
    return torch.where(bits >= drop_threshold(rate), a * (1.0 / (1.0 - rate)),
                       0.0)


def site_dropout(a, seeds, salt, rate):
    """Inverted dropout of a [R, A, B] tile by the counter hash (`_drop32`):
    the row's seed and the site's salt pick the mask."""
    if rate <= 0.0:
        return a
    if seeds is None:
        raise ValueError("drop_rate > 0 needs per-row seeds [B, 1]")
    return _drop_bits(a, hash_bits(seeds, salt, a.shape[-2:]), rate)


# --- shared plain math ---------------------------------------------------------


def layer_norm(x, scale, bias, eps=1e-6):
    """LayerNorm over the last dim, fp32 statistics, population variance."""
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def depthwise_separable(x, dw, wp, bp):
    """relu(pointwise(depthwise(x)) + bp): x [B, T, D], dw [k, D] along T
    with SAME zero padding, wp [D, D], bp [D]."""
    k, D = dw.shape
    xt = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
    y = F.conv1d(xt, dw.t().unsqueeze(1), groups=D).transpose(1, 2)
    return torch.relu(y @ wp + bp)


def _attention_scores(q, k, v, mask, n_heads, seeds, drop_rate):
    """(out [B, T, D], the masked scores s [B, H, T, T]) of `attention`."""
    B, T, D = q.shape
    hd = D // n_heads

    def split(t):
        return t.reshape(B, T, n_heads, hd).transpose(1, 2)

    s = (split(q) * (1.0 / math.sqrt(float(hd)))) @ split(k).transpose(-1, -2)
    s = s + (1.0 - mask.to(torch.float32)).reshape(B, 1, 1, T) * -1e30
    p = torch.softmax(s, dim=-1)
    if drop_rate > 0.0:
        if seeds is None:
            raise ValueError("drop_rate > 0 needs per-row seeds [B, 1]")
        bits = torch.stack([mha_hash_bits(seeds, h, T)
                            for h in range(n_heads)], dim=1)
        p = _drop_bits(p, bits, drop_rate)
    return (p @ split(v)).transpose(1, 2).reshape(B, T, D), s


def attention(q, k, v, mask, n_heads, seeds=None, drop_rate=0.0):
    """Multi-head attention without an output projection: q, k, v [B, T, D],
    key mask [B, T] added as (1 - m) * -1e30, fp32 softmax, then each
    head's probabilities dropped by its counter hash (at (t, j) of the
    head's [T, T] tile)."""
    return _attention_scores(q, k, v, mask, n_heads, seeds, drop_rate)[0]


# --- 1. LSTM recurrence --------------------------------------------------------
# Replaces vslnet_tpu/ops/pallas_kernels.py:_lstm_fwd_lean_kernel,
# _lstm_fwd_kernel and _lstm_bwd_kernel (via fused_lstm_recurrence and its
# VJP). Kernels: csrc/lstm.cu. The forwards run as thread-block clusters
# (lstm_plan): each CTA keeps its slice of k_h in shared memory for all T
# steps and sends its slice of the new h to every CTA of the cluster
# through distributed shared memory, so a step is bound by its on-chip
# dot product, gate math and exchange latency, not by L2. The backward runs
# on the same plan in reverse: each CTA keeps its units' k_h rows in shared
# memory and sends its slice of each step's dgates to every CTA.

LSTM_CLUSTER = 8          # CTAs a cluster: the most every sm_90 part schedules
LSTM_ROWS = (1, 2, 4, 8)  # batch rows a cluster the kernel is built for
# the (unit, lane) threads a CTA aims at; 128 and 2 rows a cluster measured
# fastest at the main path's shape (PERF.md, the LSTM plans)
_LSTM_THREADS = 128


class LSTMPlan(NamedTuple):
    """One launch of the cluster-resident forward: clusters of `n` CTAs,
    each owning `units` hidden units (the last CTA's range may be ragged)
    of `bt` batch rows; `splits` neighbouring lanes of a warp share a unit,
    each taking every splits-th float4 of H; `threads` a CTA, `smem` bytes
    of the forward's dynamic shared memory, `smem_bwd` the backward's;
    `clusters` = ceil(B / bt)."""
    n: int
    bt: int
    units: int
    splits: int
    threads: int
    smem: int
    clusters: int
    smem_bwd: int


def lstm_plan(B, H):
    """The forward kernels' launch plan for B rows of hidden size H:
    clusters of up to LSTM_CLUSTER CTAs, 2 rows a cluster (fewer for B = 1,
    more where the clusters would not fit the card's SMs at one CTA each)
    and about _LSTM_THREADS (unit, lane) threads a CTA. The lanes a unit
    are a power of two from bt to 32. `smem` is the size of csrc/lstm.cu's
    FwdLayout, which the launch computes itself: two mbarriers; k_h's 4U
    columns, each H floats padded to an odd number of float4s; h [2, bt,
    4 ceil(H/4)]. `smem_bwd` is csrc/lstm.cu's BwdLayout: two mbarriers;
    the 4H floats of k_h's U rows, each gate's H padded to whole float4s and
    a row to an odd number of float4s; the dgates [2, bt, 4 ceil(H/4) * 4]."""
    if not 1 <= H <= 256 or B < 1:
        raise ValueError("lstm_plan: needs 1 <= H <= 256 and B >= 1, got "
                         "B=%d, H=%d" % (B, H))
    units = -(-H // min(LSTM_CLUSTER, H))
    n = -(-H // units)  # no CTA without a unit
    fits = [r for r in LSTM_ROWS[1:] if -(-B // r) * n <= N_SMS]
    bt = min(1 << (B - 1).bit_length(), fits[0] if fits else LSTM_ROWS[-1])
    hq = -(-H // 4)
    lanes = max(1, _LSTM_THREADS // units)
    splits = max(bt, min(32, 1 << (hq - 1).bit_length(),
                         1 << (lanes.bit_length() - 1)))
    threads = -(-units * splits // 32) * 32
    smem = 16 + 4 * (16 * units * (hq | 1) + 8 * bt * hq)
    smem_bwd = 16 + 16 * (units * (4 * hq | 1) + 8 * bt * hq)
    return LSTMPlan(n, bt, units, splits, threads, smem, -(-B // bt), smem_bwd)


def lstm_recurrence_plain(x_proj, k_h, valid):
    """[T, B, 4H] pre-projected inputs, [H, 4H] recurrent kernel, [T, B]
    validity -> [T, B, H]; TF gates [i, j, f, o], forget bias 1, state
    frozen and output zeroed where valid is 0. Its gradient is torch's
    autograd through the loop."""
    T, B, G = x_proj.shape
    H = G // 4
    h = x_proj.new_zeros(B, H)
    c = x_proj.new_zeros(B, H)
    outs = []
    for t in range(T):
        gates = x_proj[t] + h @ k_h
        i, j, f, o = gates.split(H, dim=-1)
        v = valid[t][:, None]
        new_c = c * torch.sigmoid(f + 1.0) + torch.sigmoid(i) * torch.tanh(j)
        new_h = torch.tanh(new_c) * torch.sigmoid(o)
        c = v * new_c + (1.0 - v) * c
        out = v * new_h
        h = out + (1.0 - v) * h
        outs.append(out)
    return torch.stack(outs)


def _lstm_shapes(name, x_proj, k_h, valid):
    """(T, B, H, the plan's ints for csrc/lstm.cu): the forward's shapes
    checked, then planned."""
    T, B, G = x_proj.shape
    H = G // 4
    if G != 4 * H or not 1 <= H <= 256 or B < 1:
        raise ValueError("%s: needs x_proj [T, B, 4H] with B >= 1 and H <= "
                         "256, got %s" % (name, tuple(x_proj.shape)))
    _check(name, x_proj, (T, B, 4 * H))
    _check(name, k_h, (H, 4 * H))
    _check(name, valid, (T, B))
    plan = lstm_plan(B, H)
    return T, B, H, (plan.n, plan.bt, plan.splits, plan.threads)


def launch_lstm_fwd(x_proj, k_h, valid):
    """The lean forward kernel (no residuals): CUDA tensors only."""
    name = "lstm_recurrence_fwd"
    T, B, H, plan = _lstm_shapes(name, x_proj, k_h, valid)
    _require_cuda(name, x_proj, k_h, valid)
    out = _empty(x_proj.device, T, B, H)
    _launch(name, x_proj.data_ptr(), k_h.data_ptr(), valid.data_ptr(),
            out.data_ptr(), T, B, H, *plan)
    return out


def launch_lstm_fwd_res(x_proj, k_h, valid):
    """The forward kernel with residuals: (out, acts [T, B, 4H], tanh(c~),
    c_prev, h_prev [T, B, H]). CUDA tensors only."""
    name = "lstm_recurrence_fwd_res"
    T, B, H, plan = _lstm_shapes(name, x_proj, k_h, valid)
    _require_cuda(name, x_proj, k_h, valid)
    dev = x_proj.device
    out, th, c_prev, h_prev = (_empty(dev, T, B, H) for _ in range(4))
    acts = _empty(dev, T, B, 4 * H)
    _launch(name, x_proj.data_ptr(), k_h.data_ptr(), valid.data_ptr(),
            out.data_ptr(), acts.data_ptr(), th.data_ptr(), c_prev.data_ptr(),
            h_prev.data_ptr(), T, B, H, *plan)
    return out, acts, th, c_prev, h_prev


def launch_lstm_bwd(dy, acts, th, c_prev, h_prev, valid, k_h):
    """The reverse recurrence and dk_h: (dx_proj [T, B, 4H], dk_h [H, 4H]).
    CUDA tensors only."""
    name = "lstm_recurrence_bwd"
    _require_cuda(name, dy, acts, th, c_prev, h_prev, valid, k_h)
    T, B, H = dy.shape
    for t, shape in ((dy, (T, B, H)), (acts, (T, B, 4 * H)), (th, (T, B, H)),
                     (c_prev, (T, B, H)), (h_prev, (T, B, H)), (valid, (T, B)),
                     (k_h, (H, 4 * H))):
        _check(name, t, shape)
    if not 1 <= H <= 256 or B < 1:
        raise ValueError("%s: needs dy [T, B, H] with B >= 1 and H <= 256, "
                         "got %s" % (name, tuple(dy.shape)))
    plan = lstm_plan(B, H)
    dev = dy.device
    dxp = _empty(dev, T, B, 4 * H)
    dkh = _empty(dev, H, 4 * H)
    splits = _wgrad_splits(1, H, 4 * H, T * B)
    ws = _empty(dev, splits * H * 4 * H if splits > 1 else 1)
    _launch(name, dy.data_ptr(), acts.data_ptr(), th.data_ptr(),
            c_prev.data_ptr(), h_prev.data_ptr(), valid.data_ptr(),
            k_h.data_ptr(), dxp.data_ptr(), dkh.data_ptr(), ws.data_ptr(),
            splits, T, B, H, plan.n, plan.bt, plan.splits, plan.threads)
    return dxp, dkh


class FusedLSTMRecurrence(torch.autograd.Function):
    """The recurrence on the card: the residual forward kernel, then the
    reverse kernel in backward (`fused_lstm_recurrence`'s VJP)."""

    @staticmethod
    def forward(ctx, x_proj, k_h, valid):
        out, acts, th, c_prev, h_prev = launch_lstm_fwd_res(x_proj, k_h, valid)
        ctx.save_for_backward(acts, th, c_prev, h_prev, valid, k_h)
        return out

    @staticmethod
    def backward(ctx, dy):
        acts, th, c_prev, h_prev, valid, k_h = ctx.saved_tensors
        dxp, dkh = launch_lstm_bwd(dy.contiguous(), acts, th, c_prev, h_prev,
                                   valid, k_h)
        return dxp, dkh, None


def fused_lstm_recurrence(x_proj, k_h, valid):
    """On the card: the lean kernel where no gradient is needed, else
    FusedLSTMRecurrence. On the CPU: the plain version."""
    name = "lstm_recurrence_fwd"
    if not _on_cuda(name, x_proj, k_h, valid):
        return lstm_recurrence_plain(x_proj, k_h, valid)
    if torch.is_grad_enabled() and (x_proj.requires_grad or k_h.requires_grad):
        return FusedLSTMRecurrence.apply(x_proj, k_h, valid)
    return launch_lstm_fwd(x_proj, k_h, valid)


# --- 2. conv block -------------------------------------------------------------
# Replaces vslnet_tpu/ops/pallas_kernels.py:_make_conv_block_fwd_kernel and
# _make_conv_block_bwd_kernel (via fused_conv_block). Kernels:
# csrc/conv_block.cu. All L layers run in one launch, a thread-block
# cluster a batch row each way, the depthwise halo through distributed
# shared memory: the forward on conv_fwd_plan's CTAs, each keeping its
# frames of the residual stream in shared memory; the backward on
# conv_plan's, each replaying the forward over its own frames and keeping
# every layer's input, LayerNorm output and ReLU and dropout masks for the
# walk back.


def conv_block_plain(x, gam, beta, dw, wp, bp, seeds=None, drop_rate=0.0):
    """L x {x + drop(relu(pointwise(depthwise(LN(x))) + bp))}: x [B, T, D],
    gam/beta/bp [L, D], dw [L, k, D], wp [L, D, D]; layer l's dropout is the
    counter hash with salt 0x100 + l and the row seeds [B, 1]."""
    for l in range(gam.shape[0]):
        r = depthwise_separable(layer_norm(x, gam[l], beta[l]), dw[l], wp[l],
                                bp[l])
        x = x + site_dropout(r, seeds, 0x100 + l, drop_rate)
    return x


CONV_CLUSTER = 8  # the most CTAs a row: the most every sm_90 part schedules
# CTAs a row where they fit: the H100 holds 17 clusters of 6 CTAs of ~225 KB
# of shared memory at once, so B = 16 rows run in one wave; clusters of 7 or
# 8 such CTAs fit 15 times (vslnet_torch/bench/conv_plans.py measures it)
CONV_ROW_CTAS = 6


def _conv_smem_bytes(frames, D, K, L):
    """csrc/conv_block.cu BwdLayout's bytes for `frames` frames a CTA."""
    fd, hd = frames * D, (frames + K - 1) * D
    floats = (L * fd + L * hd + D * D + 2 * fd + 2 * hd + K * D
              + -(-frames // 4) * 4 + -(-L * frames * (D // 4) // 16) * 4)
    return 4 * floats


@functools.lru_cache(maxsize=256)
def _conv_plan_sizes(T, D, K, L):
    """(n, frames, shared-memory bytes) of conv_plan: CONV_ROW_CTAS CTAs a
    row, or more, up to CONV_CLUSTER, where their frames do not fit."""
    for n in range(min(T, CONV_ROW_CTAS), min(T, CONV_CLUSTER) + 1):
        frames = -(-T // n)
        smem = _conv_smem_bytes(frames, D, K, L)
        if smem <= MAX_SMEM_BYTES:
            break
    return -(-T // frames), frames, smem  # no empty CTA


class ConvPlan(NamedTuple):
    """One launch of the conv block forward or backward: clusters of `n`
    CTAs a batch row, CTA r owning the frames [r * frames, min(T, (r + 1)
    * frames)); `smem` bytes of dynamic shared memory a CTA, `ctas` = B *
    n."""
    n: int
    frames: int
    smem: int
    ctas: int


def conv_plan(B, T, D, K, L):
    """The backward kernel's launch plan for B rows of [T, D] and a
    depthwise kernel of K taps over L layers: ceil(T / CONV_ROW_CTAS) frames
    a CTA (fewer CTAs where T is short, none of them empty), or more CTAs
    where those frames do not fit a block's shared memory. `smem` is
    csrc/conv_block.cu's BwdLayout: for each layer the input, the ReLU and
    dropout masks (a bit each) of the own frames and the LayerNorm output
    over the own frames and the halo of the depthwise reach (frames + K - 1
    rows); one layer's [D, D] weights and K taps; the running gradient, a
    product operand, and g_d over frames + K - 1 rows twice; the inverse
    deviations. Raises on what the kernel cannot take."""
    if B < 1 or T < 1 or K < 1 or L < 1 or D < 4 or D % 4:
        raise ValueError("conv_plan: needs B, T, K, L >= 1 and D %% 4 == 0, "
                         "got B=%d, T=%d, D=%d, K=%d, L=%d" % (B, T, D, K, L))
    n, frames, smem = _conv_plan_sizes(T, D, K, L)
    if smem > MAX_SMEM_BYTES:
        raise ValueError("conv_plan: T=%d, D=%d needs %d bytes of shared "
                         "memory a CTA, above the %d a block has"
                         % (T, D, smem, MAX_SMEM_BYTES))
    return ConvPlan(n, frames, smem, B * n)


# CTAs a row of the forward where they fit: 6 CTAs of 22 frames at T = 128
# (~118 KB each; all 16 rows' clusters run at once), the fastest of the
# plans vslnet_torch/bench/conv_plans.py times at T = 128 and 12 (PERF.md)
CONV_FWD_ROW_CTAS = 6


def _conv_fwd_smem_bytes(frames, D, K):
    """csrc/conv_block.cu FwdLayout's bytes for `frames` frames a CTA."""
    return 4 * (2 * frames * D + 2 * (frames + K - 1) * D + D * D + K * D)


def conv_fwd_plan(B, T, D, K, L):
    """The forward kernel's launch plan for B rows of [T, D] and a depthwise
    kernel of K taps over L layers: ceil(T / CONV_FWD_ROW_CTAS) frames a
    CTA (fewer CTAs where T is short, none of them empty), or more CTAs, up
    to CONV_CLUSTER, where those frames do not fit. `smem` is
    csrc/conv_block.cu's FwdLayout: the residual stream and the depthwise
    output over the own frames, the LayerNorm output over frames + K - 1
    rows twice (by layer parity), one layer's [D, D] weights and K taps.
    Raises on what the kernel cannot take."""
    if B < 1 or T < 1 or K < 1 or L < 1 or D < 4 or D % 4:
        raise ValueError("conv_fwd_plan: needs B, T, K, L >= 1 and D %% 4 == "
                         "0, got B=%d, T=%d, D=%d, K=%d, L=%d"
                         % (B, T, D, K, L))
    for n in range(min(T, CONV_FWD_ROW_CTAS), min(T, CONV_CLUSTER) + 1):
        frames = -(-T // n)
        smem = _conv_fwd_smem_bytes(frames, D, K)
        if smem <= MAX_SMEM_BYTES:
            break
    if smem > MAX_SMEM_BYTES:
        raise ValueError("conv_fwd_plan: T=%d, D=%d needs %d bytes of shared "
                         "memory a CTA, above the %d a block has"
                         % (T, D, smem, MAX_SMEM_BYTES))
    n = -(-T // frames)  # no empty CTA
    return ConvPlan(n, frames, smem, B * n)


def _conv_shapes(name, x, gam, beta, dw, wp, bp, smem):
    B, T, D = x.shape
    L, K, _ = dw.shape
    if D % 4:
        raise ValueError("%s: needs D %% 4 == 0, got D=%d" % (name, D))
    if smem > MAX_SMEM_BYTES:
        raise ValueError("%s: T=%d, D=%d needs %d bytes of shared memory, "
                         "above the %d a block has" % (name, T, D, smem,
                                                       MAX_SMEM_BYTES))
    _check(name, x, (B, T, D))
    for t in (gam, beta, bp):
        _check(name, t, (L, D))
    _check(name, dw, (L, K, D))
    _check(name, wp, (L, D, D))
    return B, T, D, L, K


def _aligned16(*tensors):
    """The tensors, each copied where it does not start on 16 bytes: the
    conv and MHA block kernels copy their weights by 16-byte cp.async."""
    return [a if a.data_ptr() % 16 == 0 else a.clone() for a in tensors]


def launch_conv_block_fwd(x, gam, beta, dw, wp, bp, seeds=None, drop_rate=0.0):
    """The forward kernel on conv_fwd_plan's CTAs: CUDA tensors only."""
    name = "conv_block_fwd"
    _require_cuda(name, x, gam, beta, dw, wp, bp)
    B, T, D, L, K = _conv_shapes(name, x, gam, beta, dw, wp, bp, 0)
    plan = conv_fwd_plan(B, T, D, K, L)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    dw, wp = _aligned16(dw, wp)
    out = torch.empty_like(x)
    _launch(name, x.data_ptr(), gam.data_ptr(), beta.data_ptr(), dw.data_ptr(),
            wp.data_ptr(), bp.data_ptr(), sp, thresh, scale, out.data_ptr(),
            B, T, D, L, K, plan.n, plan.frames)
    return out


def launch_conv_block_bwd(x, gam, beta, dw, wp, bp, seeds, drop_rate, g):
    """The backward kernel: (dx, dgam, dbeta, ddw, dwp, dbp), the weight
    gradients summed over the batch. CUDA tensors only."""
    name = "conv_block_bwd"
    _require_cuda(name, x, gam, beta, dw, wp, bp, g)
    B, T, D, L, K = _conv_shapes(name, x, gam, beta, dw, wp, bp, 0)
    plan = conv_plan(B, T, D, K, L)
    _check(name, g, (B, T, D))
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    dev = x.device
    dw, wp = _aligned16(dw, wp)
    wpT = wp.transpose(1, 2).contiguous()
    dx = torch.empty_like(x)
    dsmall = _empty(dev, L, 3 + K, D)
    dwp = _empty(dev, L, D, D)
    d_ws, gp_ws = (_empty(dev, L, B, T, D) for _ in range(2))
    part = _empty(dev, plan.ctas, L, 3 + K, D)
    splits = _wgrad_splits(L, D, D, B * T)
    ws = _empty(dev, L * splits * D * D if splits > 1 else 1)
    _launch(name, x.data_ptr(), gam.data_ptr(), beta.data_ptr(), dw.data_ptr(),
            wp.data_ptr(), wpT.data_ptr(), bp.data_ptr(), sp, thresh, scale,
            g.data_ptr(), dx.data_ptr(), dsmall.data_ptr(), dwp.data_ptr(),
            d_ws.data_ptr(), gp_ws.data_ptr(), part.data_ptr(), ws.data_ptr(),
            splits, B, T, D, L, K, plan.n, plan.frames)
    return dx, dsmall[:, 0], dsmall[:, 1], dsmall[:, 3:], dwp, dsmall[:, 2]


class FusedConvBlock(torch.autograd.Function):
    """The conv block on the card: forward kernel, backward kernel."""

    @staticmethod
    def forward(ctx, x, gam, beta, dw, wp, bp, seeds, drop_rate):
        out = launch_conv_block_fwd(x, gam, beta, dw, wp, bp, seeds, drop_rate)
        ctx.save_for_backward(x, gam, beta, dw, wp, bp, seeds)
        ctx.drop_rate = drop_rate
        return out

    @staticmethod
    def backward(ctx, g):
        x, gam, beta, dw, wp, bp, seeds = ctx.saved_tensors
        grads = launch_conv_block_bwd(x, gam, beta, dw, wp, bp, seeds,
                                      ctx.drop_rate, g.contiguous())
        return (*grads, None, None)


def fused_conv_block(x, gam, beta, dw, wp, bp, seeds=None, drop_rate=0.0):
    """On the card: the whole-row kernels or the T-tiled ones, as
    conv_route says for a call that takes a gradient (training) or not
    (serving); the backward is its forward's route's. On the CPU: the plain
    version."""
    name = "conv_block_fwd"
    tensors = [x, gam, beta, dw, wp, bp] + ([] if seeds is None else [seeds])
    if not _on_cuda(name, *tensors):
        return conv_block_plain(x, gam, beta, dw, wp, bp, seeds, drop_rate)
    L, K, _ = dw.shape
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    fn = FusedConvBlock if conv_route(*x.shape[1:], K, L, grad) == "block" \
        else FusedConvBlockTiled
    return fn.apply(x, gam, beta, dw, wp, bp, seeds, float(drop_rate))


# --- 2b. conv block at any T ---------------------------------------------------
# The same function as section 2, T-tiled (csrc/conv_block.cu, the tiled
# kernels): one launch a layer over (T-tiles, rows). The forward's tiles, on
# conv_tiled_fwd_plan, each LayerNorm their frames and the depthwise reach
# out of shared memory; the backward's, on conv_tiled_bwd_plan, each
# recompute the depthwise output, the pre-ReLU and g_d over the reach as
# well, so that a layer is one launch. Taken where a row's backward does not
# fit a block (T > 145 at D = 128).

# the tiled kernels' threads a CTA (csrc/conv_block.cu kTiledThreads), the
# rows of the backward's and the forward's product tiles they are built
# for, and the frames a tile their plans choose from
CONV_TILED_THREADS = 512
CONV_TILED_ROWS = (4, 6)
CONV_TILED_FWD_ROWS = (2, 4)
CONV_TILED_FRAMES = (8, 16, 24, 32, 40, 48, 56, 64)
# the blocks of its split-K dwp product fill the SMs this many times: its
# 64 x 64 tiles wait on their loads, and 4 waves beat 1 and 2 at paths L
# and M (vslnet_torch/bench/conv_plans.py --tiled, PERF.md)
CONV_TILED_WGRAD_WAVES = 4


# the shortest T at which the tiled kernels beat the whole-row ones on the
# card: the forward alone from T = 24 (serving), forward and backward
# together from T = 48 (training), at D = 128 and B = 1 to 16
# (vslnet_torch/bench/conv_plans.py --route, PERF.md); below, the
# whole-row kernels' one launch beats the tiled kernels' L
CONV_TILED_FWD_T = 24
CONV_TILED_PAIR_T = 48


def conv_route(T, D, K, L, grad=False):
    """"block" (the whole-row forward, the backward a cluster a row) for
    rows shorter than CONV_TILED_FWD_T frames, or CONV_TILED_PAIR_T where a
    backward follows (grad), and where the whole-row kernels fit: the
    route's T limit and conv_plan's CTAs; else "tiled". The T limit is the
    one the whole-row backward had when it was one block a row: three
    [T, D] rows, T inverse deviations and 16 D floats of LN reductions in a
    block's shared memory (T <= 145 at D = 128)."""
    t_limit = (3 * T * D + T + 16 * D) * 4 <= MAX_SMEM_BYTES
    plan_fits = _conv_plan_sizes(T, D, K, L)[2] <= MAX_SMEM_BYTES
    short = T < (CONV_TILED_PAIR_T if grad else CONV_TILED_FWD_T)
    return "block" if t_limit and plan_fits and short else "tiled"


def _conv_tiled_bwd_smem_bytes(frames, D, K, sk):
    """csrc/conv_block.cu TiledBwdLayout's bytes for `frames` frames a tile
    and weight slices of `sk` rows."""
    return 4 * ((frames + 2 * (K - 1)) * D + 2 * (frames + K - 1) * D
                + frames * D + (1 if sk == D else 2) * sk * D + K * D
                + -(-frames // 4) * 4)


class ConvTiledBwdPlan(NamedTuple):
    """One call of the tiled conv backward: each of L launches on `ctas` =
    B * `tiles` CTAs of CONV_TILED_THREADS threads, a CTA taking `frames`
    frames of a row (tiles = ceil(T / frames)) and `smem` bytes, wp and
    wp^T streamed in slices of `slice` rows (D / slice slices), its
    products in items of `product_rows` rows x 4 columns."""
    frames: int
    tiles: int
    slice: int
    smem: int
    ctas: int
    product_rows: int


def _conv_tiled_rows(frames, D, K):
    """The backward's product tile's rows for a tile of `frames` frames: the
    fewest of CONV_TILED_ROWS whose items over its frames + K - 1 rows fit
    one round of the CTA's threads, else the most."""
    for rows in CONV_TILED_ROWS:
        if -(-(frames + K - 1) // rows) * (D // 4) <= CONV_TILED_THREADS:
            return rows
    return CONV_TILED_ROWS[-1]


def _largest_slice(D, fits):
    """The largest slice of wp's rows (a multiple of 4 dividing D, all of D
    first) for which fits(slice) holds, or None."""
    for sk in range(D, 3, -4):
        if D % sk == 0 and fits(sk):
            return sk
    return None


def _conv_tiled_slice(frames, D, K):
    """The backward's wp slice with which `frames` frames fit a block."""
    return _largest_slice(D, lambda sk: _conv_tiled_bwd_smem_bytes(
        frames, D, K, sk) <= MAX_SMEM_BYTES)


@functools.lru_cache(maxsize=256)
def conv_tiled_bwd_plan(B, T, D, K, L):
    """The tiled backward's launch plan for B rows of [T, D] and a depthwise
    kernel of K taps over L layers. A tile of F frames runs its passes
    over F + K - 1 rows on one CTA an SM, so its time goes as ceil((F + K -
    1) / 4), times the waves of B * ceil(T / F) CTAs over the card's SMs:
    the plan takes the F of CONV_TILED_FRAMES (cut to T) that needs the
    least, the larger F on a tie, with wp whole in shared memory where it
    fits and else in the largest slices that do, and the product rows of
    _conv_tiled_rows. At path L's [8, 1024, 128]: 128 CTAs of 64 frames
    (one wave, 213 KB each), products of 6 rows an item; at path M's [16,
    192, 128], 128 of 24. Raises on what the kernel cannot take."""
    if B < 1 or T < 1 or K < 1 or L < 1 or D < 4 or D % 4:
        raise ValueError("conv_tiled_bwd_plan: needs B, T, K, L >= 1 and D %% "
                         "4 == 0, got B=%d, T=%d, D=%d, K=%d, L=%d"
                         % (B, T, D, K, L))
    best = None
    for frames in sorted({min(T, f) for f in CONV_TILED_FRAMES}):
        sk = _conv_tiled_slice(frames, D, K)
        if sk is None:
            continue
        tiles = -(-T // frames)
        cost = -(-B * tiles // N_SMS) * -(-(frames + K - 1) // 4)
        if best is None or cost <= best[0]:
            best = (cost, ConvTiledBwdPlan(
                frames, tiles, sk,
                _conv_tiled_bwd_smem_bytes(frames, D, K, sk), B * tiles,
                _conv_tiled_rows(frames, D, K)))
    if best is None:
        raise ValueError("conv_tiled_bwd_plan: D=%d needs %d bytes of shared "
                         "memory a tile of %d frames, above the %d a block "
                         "has" % (D, _conv_tiled_bwd_smem_bytes(
                             min(T, CONV_TILED_FRAMES[0]), D, K, 4),
                             min(T, CONV_TILED_FRAMES[0]), MAX_SMEM_BYTES))
    return best[1]


def _conv_tiled_fwd_smem_bytes(frames, D, K, sk):
    """csrc/conv_block.cu TiledFwdLayout's bytes for `frames` frames a tile
    and weight slices of `sk` rows."""
    return 4 * ((frames + K - 1) * D + frames * D
                + (frames * D if sk < D else 0)
                + (1 if sk == D else 2) * sk * D + K * D)


def _conv_tiled_fwd_slice(frames, D, K):
    """The forward's wp slice with which `frames` frames fit a block."""
    return _largest_slice(D, lambda sk: _conv_tiled_fwd_smem_bytes(
        frames, D, K, sk) <= MAX_SMEM_BYTES)


def _conv_tiled_fwd_rows(frames, D):
    """The forward's product rows for a tile of `frames` frames: the most
    of CONV_TILED_FWD_ROWS whose items (rows x 4 columns) still number a
    quarter of the CTA's threads, else the fewest. At D = 128: 4 rows from
    16 frames up, 2 at 8 (vslnet_torch/bench/conv_plans.py --tiled: 4 rows
    beat 2 by 3-20% at 16-64 frames, and 8 rows, 2 beat 4 by 16% at 8)."""
    for rows in reversed(CONV_TILED_FWD_ROWS):
        if -(-frames // rows) * (D // 4) >= CONV_TILED_THREADS // 4:
            return rows
    return CONV_TILED_FWD_ROWS[0]


class ConvTiledFwdPlan(NamedTuple):
    """One call of the tiled conv forward: each of L launches on `ctas` = B
    * `tiles` CTAs of CONV_TILED_THREADS threads, a CTA taking `frames`
    frames of a row (tiles = ceil(T / frames)) and `smem` bytes, wp in
    slices of `slice` rows (D / slice slices), its product in items of
    `product_rows` rows x 4 columns."""
    frames: int
    tiles: int
    slice: int
    smem: int
    ctas: int
    product_rows: int


@functools.lru_cache(maxsize=256)
def conv_tiled_fwd_plan(B, T, D, K, L):
    """The tiled forward's launch plan for B rows of [T, D] and a depthwise
    kernel of K taps over L layers. A tile of F frames LayerNorms F + K - 1
    rows and runs its depthwise pass and product over F on one CTA an SM,
    so its time goes as F + K - 1, times the waves of B * ceil(T / F) CTAs
    over the card's SMs: the plan takes the F of CONV_TILED_FRAMES (cut to
    T) that needs the least, the larger F on a tie, with wp whole in shared
    memory where it fits and else in the largest slices that do, and the
    product rows of _conv_tiled_fwd_rows. At path L's [8, 1024, 128]: 128
    CTAs of 64 frames (one wave, 138 KB each), products of 4 rows an item;
    at path M's [16, 192, 128], 128 of 24. Raises on what the kernel
    cannot take."""
    if B < 1 or T < 1 or K < 1 or L < 1 or D < 4 or D % 4:
        raise ValueError("conv_tiled_fwd_plan: needs B, T, K, L >= 1 and D %% "
                         "4 == 0, got B=%d, T=%d, D=%d, K=%d, L=%d"
                         % (B, T, D, K, L))
    best = None
    for frames in sorted({min(T, f) for f in CONV_TILED_FRAMES}):
        sk = _conv_tiled_fwd_slice(frames, D, K)
        if sk is None:
            continue
        tiles = -(-T // frames)
        cost = -(-B * tiles // N_SMS) * (frames + K - 1)
        if best is None or cost <= best[0]:
            best = (cost, ConvTiledFwdPlan(
                frames, tiles, sk,
                _conv_tiled_fwd_smem_bytes(frames, D, K, sk), B * tiles,
                _conv_tiled_fwd_rows(frames, D)))
    if best is None:
        frames = min(T, CONV_TILED_FRAMES[0])
        raise ValueError("conv_tiled_fwd_plan: D=%d needs %d bytes of shared "
                         "memory a tile of %d frames, above the %d a block "
                         "has" % (D, _conv_tiled_fwd_smem_bytes(frames, D, K, 4),
                                  frames, MAX_SMEM_BYTES))
    return best[1]


def launch_conv_block_fwd_tiled(x, gam, beta, dw, wp, bp, seeds=None,
                                drop_rate=0.0):
    """The tiled forward kernels on conv_tiled_fwd_plan: (out, xs [L - 1, B,
    T, D], the inputs of layers 1..L-1, which the tiled backward reads).
    CUDA tensors only; raises where the tiled backward's plan does not fit
    either."""
    name = "conv_block_fwd_tiled"
    _require_cuda(name, x, gam, beta, dw, wp, bp)
    B, T, D, L, K = _conv_shapes(name, x, gam, beta, dw, wp, bp, 0)
    plan = conv_tiled_fwd_plan(B, T, D, K, L)
    conv_tiled_bwd_plan(B, T, D, K, L)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    # x, the taps and the weights land by 16-byte cp.async, x and bp are
    # read as float4s
    x, dw, wp, bp = _aligned16(x, dw, wp, bp)
    out = torch.empty_like(x)
    xs = _empty(x.device, max(L - 1, 1), B, T, D)
    _launch(name, x.data_ptr(), gam.data_ptr(), beta.data_ptr(), dw.data_ptr(),
            wp.data_ptr(), bp.data_ptr(), sp, thresh, scale, xs.data_ptr(),
            out.data_ptr(), B, T, D, L, K, plan.frames, plan.slice,
            plan.product_rows)
    return out, xs


def launch_conv_block_bwd_tiled(x, xs, gam, beta, dw, wp, bp, seeds,
                                drop_rate, g):
    """The tiled backward kernels on conv_tiled_bwd_plan, from the forward's
    xs: (dx, dgam, dbeta, ddw, dwp, dbp), the weight gradients summed over
    the batch. CUDA tensors only."""
    name = "conv_block_bwd_tiled"
    _require_cuda(name, x, xs, gam, beta, dw, wp, bp, g)
    B, T, D, L, K = _conv_shapes(name, x, gam, beta, dw, wp, bp, 0)
    plan = conv_tiled_bwd_plan(B, T, D, K, L)
    _check(name, xs, (max(L - 1, 1), B, T, D))
    _check(name, g, (B, T, D))
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    dev = x.device
    # x, g, the taps and the weights land by 16-byte cp.async, g and bp are
    # read as float4s
    x, g, dw, wp, bp = _aligned16(x, g, dw, wp, bp)
    wpT = wp.transpose(1, 2).contiguous()
    dx = torch.empty_like(x)
    dsmall = _empty(dev, L, 3 + K, D)
    dwp = _empty(dev, L, D, D)
    d_ws, gp_ws = (_empty(dev, L, B, T, D) for _ in range(2))
    g_ws = _empty(dev, B, T, D)
    part = _empty(dev, plan.ctas, L, 3 + K, D)
    splits = _wgrad_splits(L, D, D, B * T, CONV_TILED_WGRAD_WAVES)
    ws = _empty(dev, L * splits * D * D if splits > 1 else 1)
    _launch(name, x.data_ptr(), xs.data_ptr(), gam.data_ptr(),
            beta.data_ptr(), dw.data_ptr(), wp.data_ptr(), wpT.data_ptr(),
            bp.data_ptr(), sp, thresh, scale, g.data_ptr(), dx.data_ptr(),
            dsmall.data_ptr(), dwp.data_ptr(), d_ws.data_ptr(),
            gp_ws.data_ptr(), g_ws.data_ptr(), part.data_ptr(), ws.data_ptr(),
            splits, B, T, D, L, K, plan.frames, plan.slice, plan.product_rows)
    return dx, dsmall[:, 0], dsmall[:, 1], dsmall[:, 3:], dwp, dsmall[:, 2]


class FusedConvBlockTiled(torch.autograd.Function):
    """The conv block on the card at any T: the tiled forward kernels, which
    keep each layer's input, then the tiled backward kernels."""

    @staticmethod
    def forward(ctx, x, gam, beta, dw, wp, bp, seeds, drop_rate):
        out, xs = launch_conv_block_fwd_tiled(x, gam, beta, dw, wp, bp, seeds,
                                              drop_rate)
        ctx.save_for_backward(x, xs, gam, beta, dw, wp, bp, seeds)
        ctx.drop_rate = drop_rate
        return out

    @staticmethod
    def backward(ctx, g):
        x, xs, gam, beta, dw, wp, bp, seeds = ctx.saved_tensors
        grads = launch_conv_block_bwd_tiled(x, xs, gam, beta, dw, wp, bp, seeds,
                                            ctx.drop_rate, g.contiguous())
        return (*grads, None, None)


# --- 3. MHA block --------------------------------------------------------------
# Replaces vslnet_tpu/ops/pallas_kernels.py:_make_mha_block_fwd_kernel and
# _make_mha_block_bwd_kernel (via fused_mha_block). Kernels:
# csrc/mha_block.cu, three launches each way. The forward on mha_fwd_plan:
# LN1 + QKV on tiles of frames with Wqkv streamed into shared memory, the
# attention on (query tile, head, row) CTAs, residual + LN2 + dense +
# residual on the frame tiles. The backward on mha_bwd_plan: the dense +
# LN2 and QKV + LN1 backwards on tiles of frames with the weights streamed
# into shared memory, and the attention backward as a cluster of query
# tiles a (row, head).


def _mha_block(attend, x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads,
               seeds, drop_rate):
    D = x.shape[-1]
    y = site_dropout(layer_norm(x, gam[0], beta[0]), seeds, 0x200, drop_rate)
    q, k, v = (t.contiguous() for t in (y @ wqkv + bqkv).split(D, dim=-1))
    att = attend(q, k, v, mask, n_heads, seeds, drop_rate)
    res = site_dropout(att, seeds, 0x201, drop_rate) + x
    z = site_dropout(layer_norm(res, gam[1], beta[1]), seeds, 0x202, drop_rate)
    return site_dropout(z @ wd + bd, seeds, 0x203, drop_rate) + res


def mha_block_plain(x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads,
                    seeds=None, drop_rate=0.0):
    """Pre-LN attention block: x [B, T, D], key mask [B, T], gam/beta [2, D]
    (LN1, LN2), wqkv [D, 3D], bqkv [3D], wd [D, D], bd [D]; counter-hash
    dropout at sites 0x200 (LN1 out), the probabilities, 0x201 (attention
    out), 0x202 (LN2 out) and 0x203 (dense out)."""
    return _mha_block(attention, x, mask, gam, beta, wqkv, bqkv, wd, bd,
                      n_heads, seeds, drop_rate)


def mha_block_unfused(x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads,
                      seeds=None, drop_rate=0.0):
    """The MHA block where the block kernels do not fit (mha_route "whole"
    or "flash"): mha_block_plain's PyTorch LayerNorms, projections,
    residuals and site dropouts (the same per-row seeds, so the same
    masks) around fused_mha, as the JAX package's unfused block keeps them
    in XLA around its fused_mha."""
    return _mha_block(fused_mha, x, mask, gam, beta, wqkv, bqkv, wd, bd,
                      n_heads, seeds, drop_rate)


MHA_HEAD_DIMS = (8, 16, 32, 64)


def attention_route(T, hd):
    """fused_mha's kernels: "whole" (the whole-T kernels, on the MHA block's
    attention bodies) up to the route's T limit, else "flash". The T limit
    is the one the whole-T backward had when it ran one block a (row, head):
    a head's q, k, v and g, three [T] rows and dS [T, T + 1] in a block's
    shared memory (T <= 223, 209, 183, 143 at head dims 8, 16, 32, 64),
    kept so that every shape takes the route it took then; its cluster
    (mha_whole_bwd_plan) fits every shape under it. Forward and backward
    read the same gate, so one call never mixes the routes' residuals."""
    t_limit = (4 * T * hd + 3 * T + T * (T + 1)) * 4 <= MAX_SMEM_BYTES
    return "whole" if t_limit else "flash"


def _head_dim(name, D, n_heads):
    if D % n_heads or D // n_heads not in MHA_HEAD_DIMS:
        raise ValueError("%s: head dim D/n_heads must be one of %s, got D=%d "
                         "heads=%d" % (name, MHA_HEAD_DIMS, D, n_heads))
    return D // n_heads


def mha_route(T, D, n_heads):
    """The MHA block's kernels on the card: "block" (the fused block
    kernels) up to the route's T limit, where mha_fwd_plan's and
    mha_bwd_plan's tiles also fit; else the unfused block around fused_mha's
    `attention_route`. The T limit is the one the block backward had when
    it ran one block a row, kept so that every shape takes the route it
    took then: three [T, D] rows, T inverse deviations and 16 D floats of
    LN reductions, or a head's q, k, v and g, three [T] rows and dS [T, T +
    1], in a block's shared memory (T <= 145 at D = 128). The forward of
    that time, one block a row holding (2 D + 1) T floats, lies inside the
    limit. Raises for a head dim no kernel takes."""
    hd = _head_dim("mha_route", D, n_heads)
    t_limit = (max(3 * T * D + T + 16 * D, 4 * T * hd + 3 * T + T * (T + 1))
               * 4 <= MAX_SMEM_BYTES)
    if (t_limit and _mha_fwd_sizes(T, D, hd) is not None
            and _mha_bwd_sizes(T, D, hd) is not None):
        return "block"
    return attention_route(T, hd)


# frames a tile of the backward's per-frame launches, and query rows a CTA
# of its attention launch: the fastest of the plans
# vslnet_torch/bench/mha_plans.py times at T = 128 (PERF.md)
MHA_FRAMES = 8
MHA_QTILE = 64
MHA_CLUSTER = 8  # the most query tiles a (row, head): a portable cluster


class MHABwdPlan(NamedTuple):
    """One call of the MHA block backward: the per-frame launches on
    `tiles` = ceil(T / frames) tiles a row, the weights streamed in slices
    of `slice_rows` rows, `smem_frames` bytes a CTA (the larger launch);
    the attention on clusters of `q_tiles` = ceil(T / q_tile) CTAs a (row,
    head), `smem_attention` bytes each."""
    frames: int
    tiles: int
    slice_rows: int
    smem_frames: int
    q_tile: int
    q_tiles: int
    smem_attention: int


def _mha_frames_bytes(frames, sk, D):
    """csrc/mha_block.cu qkv_tile_floats (the larger per-frame launch)."""
    return 4 * (2 * sk * D + 5 * frames * D + -(-frames // 4) * 4)


def _mha_attention_bytes(T, q_tile, hd):
    """csrc/mha_block.cu attn_tile_floats."""
    return 4 * (2 * T * (hd + 1) + 2 * q_tile * (hd + 1) + 2 * q_tile * (T + 1)
                + q_tile + T + 2 * T * hd)


@functools.lru_cache(maxsize=256)
def _mha_bwd_sizes(T, D, hd):
    """(frames, slice rows, query rows) of mha_bwd_plan at [T, D] and head
    dim hd, or None where no tile fits: tiles of MHA_FRAMES frames, weight
    slices of D / 2 rows, halved (then the frames) until a tile's shared
    memory fits; query tiles of MHA_QTILE rows, at least T / MHA_CLUSTER,
    halved while they do not fit."""
    frames, sk = min(T, MHA_FRAMES), D // 2 if D // 2 % 4 == 0 else D
    while _mha_frames_bytes(frames, sk, D) > MAX_SMEM_BYTES:
        if sk % 8 == 0:
            sk //= 2
        elif frames > 1:
            frames = -(-frames // 2)
        else:
            return None
    q_tile = _mha_cluster_q_tile(T, hd, MHA_QTILE)
    return None if q_tile is None else (frames, sk, q_tile)


def _mha_cluster_q_tile(T, hd, q_tile):
    """Query rows a CTA of the cluster attention backward at T keys and head
    dim hd: q_tile, at least T / MHA_CLUSTER (a (row, head) is one cluster),
    halved while its shared memory does not fit; None where none fits."""
    least = -(-T // MHA_CLUSTER)
    q_tile = min(T, max(q_tile, least))
    while (_mha_attention_bytes(T, q_tile, hd) > MAX_SMEM_BYTES
           and -(-q_tile // 2) >= least and q_tile > 1):
        q_tile = -(-q_tile // 2)
    if _mha_attention_bytes(T, q_tile, hd) > MAX_SMEM_BYTES:
        return None
    return q_tile


def mha_bwd_plan(B, T, D, n_heads):
    """The MHA block backward's launch plan for B rows of [T, D] and
    n_heads heads (_mha_bwd_sizes). The per-frame launches keep two weight
    slices, the tile's g and LN rows (and its dqkv [frames, 3D]); the
    attention keeps a head's k and v, its query tile's q and g, the tile's
    [q_tile, T + 1] scores, keep bits and its dK, dV partials. Raises on
    what the kernels cannot take."""
    hd = _head_dim("mha_bwd_plan", D, n_heads)
    if B < 1 or T < 1:
        raise ValueError("mha_bwd_plan: needs B, T >= 1, got B=%d, T=%d"
                         % (B, T))
    sizes = _mha_bwd_sizes(T, D, hd)
    if sizes is None:
        raise ValueError("mha_bwd_plan: T=%d, D=%d, head dim %d: no tile "
                         "fits the %d bytes of shared memory a block has"
                         % (T, D, hd, MAX_SMEM_BYTES))
    frames, sk, q_tile = sizes
    return MHABwdPlan(frames, -(-T // frames), sk,
                      _mha_frames_bytes(frames, sk, D), q_tile,
                      -(-T // q_tile), _mha_attention_bytes(T, q_tile, hd))


# query rows and threads a CTA of the whole-T backward (the MHA block
# backward's cluster attention body, which the block backward runs with
# 256 threads): the fastest at path M's [16, 192, 128] in
# vslnet_torch/bench/mha_plans.py --whole-t (PERF.md)
MHA_WHOLE_BWD_QTILE = 96
MHA_WHOLE_BWD_THREADS = 512


class MHAWholeBwdPlan(NamedTuple):
    """One call of the whole-T backward: clusters of `q_tiles` = ceil(T /
    q_tile) CTAs of `threads` threads a (row, head), `smem` bytes each."""
    q_tile: int
    q_tiles: int
    threads: int
    smem: int


def mha_whole_bwd_plan(B, T, D, n_heads):
    """The whole-T backward's launch plan for B rows of [T, D] and n_heads
    heads: query tiles of MHA_WHOLE_BWD_QTILE rows, at least T /
    MHA_CLUSTER, halved while they do not fit (_mha_cluster_q_tile). A CTA
    keeps the head's k and v, its query tile's q and g, the tile's [q_tile,
    T + 1] scores and keep bits and its dK, dV partials. Raises on what the
    kernel cannot take."""
    hd = _head_dim("mha_whole_bwd_plan", D, n_heads)
    if B < 1 or T < 1:
        raise ValueError("mha_whole_bwd_plan: needs B, T >= 1, got B=%d, T=%d"
                         % (B, T))
    q_tile = _mha_cluster_q_tile(T, hd, MHA_WHOLE_BWD_QTILE)
    if q_tile is None:
        raise ValueError("mha_whole_bwd_plan: T=%d, head dim %d: no query "
                         "tile fits the %d bytes of shared memory a block has"
                         % (T, hd, MAX_SMEM_BYTES))
    return MHAWholeBwdPlan(q_tile, -(-T // q_tile), MHA_WHOLE_BWD_THREADS,
                           _mha_attention_bytes(T, q_tile, hd))


# frames a tile of the forward's per-frame launches, rows of a weight slice
# (a fraction of D) and query rows a CTA of its attention launch: the
# fastest of the plans vslnet_torch/bench/mha_plans.py --forward times at
# T = 128 (PERF.md)
MHA_FWD_FRAMES = 8
MHA_FWD_SLICE = 4  # slices of D / 4 rows
MHA_FWD_QTILE = 32


class MHAFwdPlan(NamedTuple):
    """One call of the MHA block forward: the per-frame launches on
    `tiles` = ceil(T / frames) tiles a row, the weights streamed in slices
    of `slice_rows` rows, `smem_frames` bytes a CTA (the larger launch);
    the attention on `q_tiles` = ceil(T / q_tile) CTAs a (row, head),
    `smem_attention` bytes each."""
    frames: int
    tiles: int
    slice_rows: int
    smem_frames: int
    q_tile: int
    q_tiles: int
    smem_attention: int


def _mha_fwd_frames_bytes(frames, sk, D):
    """csrc/mha_block.cu fwd_qkv_tile_floats (the larger per-frame launch:
    fwd_out_tile_floats is 2 sk D + 3 frames D)."""
    return 4 * (6 * sk * D + 4 * frames * D)


def _mha_fwd_attention_bytes(T, q_tile, hd):
    """csrc/mha_block.cu fwd_attn_tile_floats."""
    return 4 * (2 * T * (hd + 1) + q_tile * (hd + 1) + q_tile * (T + 1) + T
                + q_tile)


@functools.lru_cache(maxsize=256)
def _mha_fwd_sizes(T, D, hd):
    """(frames, slice rows, query rows) of mha_fwd_plan at [T, D] and head
    dim hd, or None where no tile fits: tiles of MHA_FWD_FRAMES frames,
    weight slices of D / MHA_FWD_SLICE rows (a multiple of 4 dividing D),
    halved (then the frames) until a tile's shared memory fits; query
    tiles of MHA_FWD_QTILE rows, halved while they do not fit."""
    frames = min(T, MHA_FWD_FRAMES)
    sk = D // MHA_FWD_SLICE
    if sk % 4 or D % sk:
        sk = 4
    while _mha_fwd_frames_bytes(frames, sk, D) > MAX_SMEM_BYTES:
        if sk % 8 == 0:
            sk //= 2
        elif frames > 1:
            frames = -(-frames // 2)
        else:
            return None
    q_tile = min(T, MHA_FWD_QTILE)
    while _mha_fwd_attention_bytes(T, q_tile, hd) > MAX_SMEM_BYTES:
        if q_tile == 1:
            return None
        q_tile = -(-q_tile // 2)
    return frames, sk, q_tile


def mha_fwd_plan(B, T, D, n_heads):
    """The MHA block forward's launch plan for B rows of [T, D] and n_heads
    heads (_mha_fwd_sizes), the frames a tile cut to ceil(B T / N_SMS) so
    that short rows still fill the SMs (the query stream: 2 frames at B =
    16, T = 12). The per-frame launches keep two weight slices and the
    tile's rows (LN1 out and its [frames, 3D] product; the residual, LN2
    out and the dense product); the attention keeps a head's k and v, its
    query tile's q and [q_tile, T + 1] scores. Raises on what the kernels
    cannot take."""
    hd = _head_dim("mha_fwd_plan", D, n_heads)
    if B < 1 or T < 1:
        raise ValueError("mha_fwd_plan: needs B, T >= 1, got B=%d, T=%d"
                         % (B, T))
    sizes = _mha_fwd_sizes(T, D, hd)
    if sizes is None:
        raise ValueError("mha_fwd_plan: T=%d, D=%d, head dim %d: no tile "
                         "fits the %d bytes of shared memory a block has"
                         % (T, D, hd, MAX_SMEM_BYTES))
    frames, sk, q_tile = sizes
    frames = min(frames, -(-B * T // N_SMS))
    return MHAFwdPlan(frames, -(-T // frames), sk,
                      _mha_fwd_frames_bytes(frames, sk, D), q_tile,
                      -(-T // q_tile), _mha_fwd_attention_bytes(T, q_tile, hd))


def _mha_shapes(name, x, n_heads, smem, mask, gam, beta, wqkv, wd, bqkv=None,
                bd=None):
    B, T, D = x.shape
    _head_dim(name, D, n_heads)
    if smem > MAX_SMEM_BYTES:
        raise ValueError("%s: T=%d, D=%d needs %d bytes of shared memory, "
                         "above the %d a block has" % (name, T, D, smem,
                                                       MAX_SMEM_BYTES))
    _check(name, x, (B, T, D))
    _check(name, mask, (B, T))
    _check(name, gam, (2, D))
    _check(name, beta, (2, D))
    _check(name, wqkv, (D, 3 * D))
    _check(name, wd, (D, D))
    if bqkv is not None:
        _check(name, bqkv, (3 * D,))
    if bd is not None:
        _check(name, bd, (D,))
    return B, T, D


def launch_mha_block_fwd(x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads,
                         seeds=None, drop_rate=0.0):
    """The forward kernels on mha_fwd_plan's tiles: (out, qkv [B, T, 3D],
    att [B, T, D]), the last two being what the backward reads back. CUDA
    tensors only."""
    name = "mha_block_fwd"
    _require_cuda(name, x, mask, gam, beta, wqkv, bqkv, wd, bd)
    B, T, D = _mha_shapes(name, x, n_heads, 0, mask, gam, beta, wqkv, wd,
                          bqkv, bd)
    plan = mha_fwd_plan(B, T, D, n_heads)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    # the per-frame launches copy the weights by 16-byte cp.async
    wqkv, wd = _aligned16(wqkv, wd)
    qkv = _empty(x.device, B, T, 3 * D)
    att = torch.empty_like(x)
    out = torch.empty_like(x)
    _launch(name, x.data_ptr(), mask.data_ptr(), gam.data_ptr(),
            beta.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wd.data_ptr(),
            bd.data_ptr(), sp, thresh, scale, qkv.data_ptr(), att.data_ptr(),
            out.data_ptr(), B, T, D, n_heads, plan.frames, plan.slice_rows,
            plan.q_tile)
    return out, qkv, att


def launch_mha_block_bwd(x, mask, gam, beta, wqkv, wd, n_heads, seeds,
                         drop_rate, qkv, att, g):
    """The backward kernels on mha_bwd_plan's tiles: (dx, dgam, dbeta,
    dwqkv, dbqkv, dwd, dbd), the weight gradients summed over the batch.
    CUDA tensors only."""
    name = "mha_block_bwd"
    _require_cuda(name, x, mask, gam, beta, wqkv, wd, qkv, att, g)
    B, T, D = _mha_shapes(name, x, n_heads, 0, mask, gam, beta, wqkv, wd)
    for t, shape in ((qkv, (B, T, 3 * D)), (att, (B, T, D)), (g, (B, T, D))):
        _check(name, t, shape)
    plan = mha_bwd_plan(B, T, D, n_heads)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    dev = x.device
    # the per-frame launches copy the weights by 16-byte cp.async
    wqkvT = wqkv.t().contiguous()
    wdT = wd.t().contiguous()
    dx = torch.empty_like(x)
    dsmall = _empty(dev, 8 * D)
    dwqkv = _empty(dev, D, 3 * D)
    dwd = _empty(dev, D, D)
    # one allocation for the workspaces: z, g_dpre, g_res, g_att, y [B, T,
    # D], dqkv [B, T, 3D], the tiles' partials and the split-K partials
    splits = _wgrad_splits(1, D, 3 * D, B * T)
    btd, n_part = B * T * D, B * plan.tiles * 8 * D
    work = _empty(dev, 8 * btd + n_part + (splits * D * 3 * D if splits > 1
                                           else 1))
    z, gdpre, gres, gatt, y = (work[i * btd:] for i in range(5))
    dqkv, part, ws = work[5 * btd:], work[8 * btd:], work[8 * btd + n_part:]
    _launch(name, x.data_ptr(), mask.data_ptr(), gam.data_ptr(),
            beta.data_ptr(), wqkvT.data_ptr(), wdT.data_ptr(), sp, thresh,
            scale, qkv.data_ptr(), att.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dsmall.data_ptr(), dwqkv.data_ptr(), dwd.data_ptr(), z.data_ptr(),
            gdpre.data_ptr(), gres.data_ptr(), gatt.data_ptr(), y.data_ptr(),
            dqkv.data_ptr(), part.data_ptr(), ws.data_ptr(), splits, B, T, D,
            n_heads, plan.frames, plan.slice_rows, plan.q_tile)
    return (dx, dsmall[:2 * D].view(2, D), dsmall[2 * D:4 * D].view(2, D),
            dwqkv, dsmall[4 * D:7 * D], dwd, dsmall[7 * D:])


class FusedMHABlock(torch.autograd.Function):
    """The MHA block on the card: forward kernels, backward kernels; qkv
    and the attention output are kept from the forward."""

    @staticmethod
    def forward(ctx, x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads, seeds,
                drop_rate):
        out, qkv, att = launch_mha_block_fwd(x, mask, gam, beta, wqkv, bqkv,
                                             wd, bd, n_heads, seeds, drop_rate)
        ctx.save_for_backward(x, mask, gam, beta, wqkv, wd, seeds, qkv, att)
        ctx.n_heads, ctx.drop_rate = n_heads, drop_rate
        return out

    @staticmethod
    def backward(ctx, g):
        x, mask, gam, beta, wqkv, wd, seeds, qkv, att = ctx.saved_tensors
        dx, dgam, dbeta, dwqkv, dbqkv, dwd, dbd = launch_mha_block_bwd(
            x, mask, gam, beta, wqkv, wd, ctx.n_heads, seeds, ctx.drop_rate,
            qkv, att, g.contiguous())
        return (dx, None, dgam, dbeta, dwqkv, dbqkv, dwd, dbd, None, None,
                None)


def fused_mha_block(x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads,
                    seeds=None, drop_rate=0.0):
    """On the card: the block kernels where mha_route says "block", else
    mha_block_unfused (fused_mha's whole-T or flash kernels). On the CPU:
    the plain version."""
    name = "mha_block_fwd"
    tensors = [x, mask, gam, beta, wqkv, bqkv, wd, bd]
    if seeds is not None:
        tensors.append(seeds)
    args = (x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads, seeds)
    if not _on_cuda(name, *tensors):
        return mha_block_plain(*args, drop_rate)
    if mha_route(x.shape[1], x.shape[2], n_heads) == "block":
        return FusedMHABlock.apply(*args, float(drop_rate))
    return mha_block_unfused(*args, float(drop_rate))


# --- 3b. multi-head attention at any T -----------------------------------------
# Replaces vslnet_tpu/ops/pallas_kernels.py:_make_mha_fwd_kernel and
# _make_mha_bwd_kernel (whole-T; csrc/mha_block.cu: the forward on the MHA
# block forward's attention body, the backward on the block backward's
# cluster of query tiles, mha_whole_bwd_plan), _make_flash_fwd_kernel and
# _make_flash_bwd_kernel (csrc/flash_mha.cu), via fused_mha and its VJP.
# attention_route picks one route for both directions. The whole-T
# kernels' products run register-tiled out of shared memory; the flash
# forward runs on flash_fwd_plan, several query rows a thread against key
# tiles streamed through shared memory; the flash backward on
# flash_bwd_plan, one pass over key-tile CTAs with its products
# register-tiled out of shared memory.

# keys a CTA of the flash backward at head dims up to 32 (64 above: the
# kernel keeps 2 keys x 8 dims of dK and dV a thread in registers, for at
# most 512 threads; 128 beat 64 at path L, PERF.md; csrc/flash_mha.cu
# bwd_key_tile), and query rows a streamed tile (kBwdQ)
FLASH_KEY_TILE = 128
FLASH_QTILE = 64


class FlashBwdPlan(NamedTuple):
    """One call of the flash backward: `key_tiles` = ceil(T / key_tile)
    CTAs a (row, head), each streaming `q_tiles` = ceil(T / q_tile) query
    tiles, `smem_bytes` each; the key tiles' dQ partials in a workspace of
    `workspace_bytes`, summed in key-tile order."""
    key_tile: int
    key_tiles: int
    q_tile: int
    q_tiles: int
    smem_bytes: int
    workspace_bytes: int


def _flash_bwd_bytes(key_tile, hd):
    """csrc/flash_mha.cu flash_bwd_floats."""
    return 4 * (2 * key_tile * (hd + 1) + key_tile * hd + 4 * FLASH_QTILE * hd
                + 4 * FLASH_QTILE + key_tile + 2 * FLASH_QTILE * (key_tile + 1)
                + 8192)


def flash_bwd_plan(B, T, D, n_heads):
    """The flash backward's launch plan for B rows of [T, D] and n_heads
    heads: key tiles of FLASH_KEY_TILE keys (half that at head dim 64).
    Each CTA keeps a key tile's k and v, two buffers of a query tile's q,
    g, lse and delta, the tile's drop(P) and dS [q_tile, key_tile + 1] and
    its dQ sums over key groups (139 KB at head dim 16). Raises on what the
    kernels cannot take."""
    hd = _head_dim("flash_bwd_plan", D, n_heads)
    if B < 1 or T < 1:
        raise ValueError("flash_bwd_plan: needs B, T >= 1, got B=%d, T=%d"
                         % (B, T))
    key_tile = FLASH_KEY_TILE if hd * FLASH_KEY_TILE <= 4096 else \
        FLASH_KEY_TILE // 2
    key_tiles = -(-T // key_tile)
    return FlashBwdPlan(key_tile, key_tiles, FLASH_QTILE, -(-T // FLASH_QTILE),
                        _flash_bwd_bytes(key_tile, hd),
                        4 * key_tiles * B * T * D)


# the flash forward's query slots a CTA, thread groups that split a key
# tile, keys a streamed tile and keys a step of its online softmax
# (csrc/flash_mha.cu kFwdThreads, kFwdGroups, kFwdKeys, kFwdBlock)
FLASH_FWD_THREADS = 64
FLASH_FWD_GROUPS = 2
FLASH_FWD_KEYS = 64
FLASH_FWD_BLOCK = 8


class FlashFwdPlan(NamedTuple):
    """One call of the flash forward: `ctas` = q_tiles * n_heads * B CTAs
    of `threads` threads in `groups` groups, each thread keeping `rows`
    query rows, so a CTA takes `q_tile` = rows * threads / groups queries
    (q_tiles = ceil(T / q_tile)) and streams the head's `key_tiles` =
    ceil(T / key_tile) key tiles through two buffers, each group taking
    its share of a tile in steps of `key_block` keys; `smem_bytes` holds
    the buffers, then the groups' partial softmaxes."""
    rows: int
    threads: int
    groups: int
    q_tile: int
    q_tiles: int
    key_tile: int
    key_tiles: int
    key_block: int
    smem_bytes: int
    ctas: int


def flash_fwd_plan(B, T, D, n_heads):
    """The flash forward's launch plan for B rows of [T, D] and n_heads
    heads: 2 query rows a thread up to head dim 16 (a thread's q and P.V
    accumulator of both rows in registers), 1 above; key tiles of
    FLASH_FWD_KEYS, split between FLASH_FWD_GROUPS groups of threads. Path
    L's [8, 1024, 128] in 8 heads of 16: 512 CTAs of 128 threads and 128
    queries, 16 key tiles each. Raises on what the kernel cannot take."""
    hd = _head_dim("flash_fwd_plan", D, n_heads)
    if B < 1 or T < 1:
        raise ValueError("flash_fwd_plan: needs B, T >= 1, got B=%d, T=%d"
                         % (B, T))
    rows = 2 if hd <= 16 else 1
    q_tile = rows * FLASH_FWD_THREADS
    q_tiles = -(-T // q_tile)
    smem = 4 * max(2 * (2 * FLASH_FWD_KEYS * hd + FLASH_FWD_KEYS),
                   (FLASH_FWD_GROUPS - 1) * rows * (hd + 2) * FLASH_FWD_THREADS)
    return FlashFwdPlan(rows, FLASH_FWD_THREADS * FLASH_FWD_GROUPS,
                        FLASH_FWD_GROUPS, q_tile, q_tiles, FLASH_FWD_KEYS,
                        -(-T // FLASH_FWD_KEYS), FLASH_FWD_BLOCK, smem,
                        q_tiles * n_heads * B)


def flash_attention_plain(q, k, v, mask, n_heads, seeds=None, drop_rate=0.0):
    """(out, lse [B, H, T]): attention's output and the logsumexp over the
    keys of each head's masked, scaled scores (what the flash forward
    saves)."""
    out, s = _attention_scores(q, k, v, mask, n_heads, seeds, drop_rate)
    return out, torch.logsumexp(s, dim=-1)


def _attention_shapes(name, q, k, v, mask, n_heads, *more):
    B, T, D = q.shape
    _head_dim(name, D, n_heads)
    for t in (q, k, v, *more):
        _check(name, t, (B, T, D))
    _check(name, mask, (B, T))
    return B, T, D


# query rows a CTA of the whole-T forward (the MHA block forward's
# attention body): the fastest at path M's [16, 192, 128] in
# vslnet_torch/bench/mha_plans.py --forward (PERF.md)
MHA_WHOLE_QTILE = 32


def launch_mha_fwd(q, k, v, mask, n_heads, seeds=None, drop_rate=0.0):
    """The whole-T forward kernel: out [B, T, D]. CUDA tensors only."""
    name = "mha_fwd"
    _require_cuda(name, q, k, v, mask)
    B, T, D = _attention_shapes(name, q, k, v, mask, n_heads)
    q_tile = min(T, MHA_WHOLE_QTILE)
    smem = _mha_fwd_attention_bytes(T, q_tile, D // n_heads)
    if smem > MAX_SMEM_BYTES:
        raise ValueError("%s: T=%d needs %d bytes of shared memory, above the "
                         "%d a block has" % (name, T, smem, MAX_SMEM_BYTES))
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    out = torch.empty_like(q)
    _launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            sp, thresh, scale, out.data_ptr(), B, T, D, n_heads, q_tile)
    return out


def launch_mha_bwd(q, k, v, mask, n_heads, seeds, drop_rate, out, g):
    """The whole-T backward kernel on mha_whole_bwd_plan (P recomputed, D_t
    = g . out from the forward's output): (dq, dk, dv). CUDA tensors
    only."""
    name = "mha_bwd"
    _require_cuda(name, q, k, v, mask, out, g)
    B, T, D = _attention_shapes(name, q, k, v, mask, n_heads, out, g)
    plan = mha_whole_bwd_plan(B, T, D, n_heads)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    # the kernel reads a head's rows by 16-byte loads
    q, k, v, out, g = _aligned16(q, k, v, out, g)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    _launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            sp, thresh, scale, out.data_ptr(), g.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, T, D, n_heads, plan.q_tile,
            plan.threads)
    return dq, dk, dv


def launch_flash_mha_fwd(q, k, v, mask, n_heads, seeds=None, drop_rate=0.0):
    """The flash forward kernel on flash_fwd_plan: (out [B, T, D], lse [B,
    H, T]). CUDA tensors only."""
    name = "flash_mha_fwd"
    _require_cuda(name, q, k, v, mask)
    B, T, D = _attention_shapes(name, q, k, v, mask, n_heads)
    plan = flash_fwd_plan(B, T, D, n_heads)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    # q, k and v are read by 16-byte loads and cp.async
    q, k, v = _aligned16(q, k, v)
    out = torch.empty_like(q)
    lse = _empty(q.device, B, n_heads, T)
    _launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            sp, thresh, scale, out.data_ptr(), lse.data_ptr(), B, T, D,
            n_heads, plan.rows)
    return out, lse


def launch_flash_mha_bwd(q, k, v, mask, n_heads, seeds, drop_rate, out, lse,
                         g):
    """The flash backward kernels on flash_bwd_plan (P recomputed from lse):
    (dq, dk, dv). CUDA tensors only."""
    name = "flash_mha_bwd"
    _require_cuda(name, q, k, v, mask, out, lse, g)
    B, T, D = _attention_shapes(name, q, k, v, mask, n_heads, out, g)
    _check(name, lse, (B, n_heads, T))
    plan = flash_bwd_plan(B, T, D, n_heads)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # delta [B, H, T] (g . out per query), then the key tiles' dQ partials
    # [key_tiles, B, T, D]
    # (16-byte aligned: the kernel writes them as float4s)
    nd = -(-B * n_heads * T // 4) * 4
    work = _empty(q.device, nd + plan.workspace_bytes // 4)
    dqw = work[nd:]
    # the query tiles land by 16-byte cp.async
    q, g = _aligned16(q, g)
    _launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            sp, thresh, scale, out.data_ptr(), lse.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), work.data_ptr(),
            dqw.data_ptr(), B, T, D, n_heads)
    return dq, dk, dv


class FusedMHA(torch.autograd.Function):
    """fused_mha's whole-T route: forward kernel, backward kernel, which
    reads the forward's output."""

    @staticmethod
    def forward(ctx, q, k, v, mask, n_heads, seeds, drop_rate):
        out = launch_mha_fwd(q, k, v, mask, n_heads, seeds, drop_rate)
        ctx.save_for_backward(q, k, v, mask, seeds, out)
        ctx.n_heads, ctx.drop_rate = n_heads, drop_rate
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, seeds, out = ctx.saved_tensors
        return (*launch_mha_bwd(q, k, v, mask, ctx.n_heads, seeds,
                                ctx.drop_rate, out, g.contiguous()),
                None, None, None, None)


class FusedFlashMHA(torch.autograd.Function):
    """fused_mha's flash route: the forward kernel, which keeps lse, then
    the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, mask, n_heads, seeds, drop_rate):
        out, lse = launch_flash_mha_fwd(q, k, v, mask, n_heads, seeds,
                                        drop_rate)
        ctx.save_for_backward(q, k, v, mask, seeds, out, lse)
        ctx.n_heads, ctx.drop_rate = n_heads, drop_rate
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, seeds, out, lse = ctx.saved_tensors
        return (*launch_flash_mha_bwd(q, k, v, mask, ctx.n_heads, seeds,
                                      ctx.drop_rate, out, lse,
                                      g.contiguous()),
                None, None, None, None)


def fused_mha(q, k, v, mask, n_heads, seeds=None, drop_rate=0.0):
    """`attention` on the card through the whole-T or the flash kernels, as
    attention_route says; on the CPU, `attention` itself."""
    name = "mha_fwd"
    tensors = [q, k, v, mask] + ([] if seeds is None else [seeds])
    if not _on_cuda(name, *tensors):
        return attention(q, k, v, mask, n_heads, seeds, drop_rate)
    hd = _head_dim(name, q.shape[2], n_heads)
    fn = FusedMHA if attention_route(q.shape[1], hd) == "whole" else \
        FusedFlashMHA
    return fn.apply(q, k, v, mask, n_heads, seeds, float(drop_rate))


# --- 4. span decode ------------------------------------------------------------
# Replaces vslnet_tpu/ops/pallas_kernels.py:_span_decode_kernel (via
# fused_span_decode). Kernel: csrc/span_decode.cu. Launch-bound; one block
# per row, and the [T, T] banded product is replaced by exact prefix and
# suffix maxima, taken by block scans over chunks of the row held in
# registers.

# the longest row the wrapper takes (the kernel's registers hold 6144
# frames): the limit it has always had, so that it refuses what it refused
SPAN_DECODE_MAX_T = 6128


def banded_outer(start_logits, end_logits):
    """(start_prob, end_prob, outer): the two fp32 softmaxes over T and
    their outer product with cells start > end zeroed."""
    start_prob = torch.softmax(start_logits.to(torch.float32), dim=1)
    end_prob = torch.softmax(end_logits.to(torch.float32), dim=1)
    outer = torch.triu(start_prob[:, :, None] * end_prob[:, None, :])
    return start_prob, end_prob, outer


def span_decode_plain(start_logits, end_logits):
    """[B, T] masked logits -> (start_idx [B], end_idx [B]) int32 through
    the banded (start <= end) outer product of the two softmaxes; ties go
    to the first index."""
    outer = banded_outer(start_logits, end_logits)[2]
    s_idx = outer.amax(dim=2).argmax(dim=1)
    e_idx = outer.amax(dim=1).argmax(dim=1)
    return s_idx.to(torch.int32), e_idx.to(torch.int32)


def fused_span_decode(start_logits, end_logits):
    name = "span_decode"
    if not _on_cuda(name, start_logits, end_logits):
        return span_decode_plain(start_logits, end_logits)
    B, T = start_logits.shape
    _check(name, start_logits, (B, T))
    _check(name, end_logits, (B, T))
    if T > SPAN_DECODE_MAX_T:
        raise ValueError("%s: T=%d is above the %d frames the kernel takes"
                         % (name, T, SPAN_DECODE_MAX_T))
    s_idx = torch.empty(B, device=start_logits.device, dtype=torch.int32)
    e_idx = torch.empty_like(s_idx)
    _launch(name, start_logits.data_ptr(), end_logits.data_ptr(),
            s_idx.data_ptr(), e_idx.data_ptr(), B, T)
    return s_idx, e_idx


# --- 5. context-query attention ----------------------------------------------
# Replaces vslnet_tpu/ops/pallas_kernels.py:_cqa_kernel (via
# fused_cqa_concat). Kernel: csrc/cqa.cu on cqa_plan, CTAs a batch row each
# taking a tile of frames: the column softmax over T split as a
# flash-attention row is (per-tile maxima, sums and partial Sv^T.v, then
# combined in tile order). Bound by its bytes, mostly the [B, T, 4d]
# output.


def cqa_plain(video, query, v_mask, q_mask, w4v, w4q, w4mul):
    """Context-query attention up to its output projection: video [B, T, d],
    query [B, W, d], masks [B, T] / [B, W], w4v, w4q, w4mul [d] ->
    ([B, T, 4d] concat [v, v2q, v*v2q, v*q2v], [B, T, W] trilinear score)."""
    score = trilinear_score(video, query, w4v, w4q, w4mul)
    return cqa_from_score(score, video, query, v_mask, q_mask), score


def trilinear_score(video, query, w4v, w4q, w4mul):
    """[B, T, W] score v.w4v + (q.w4q)^T + (v * w4mul).q^T."""
    return ((video @ w4v)[:, :, None] + (query @ w4q)[:, None, :]
            + (video * w4mul) @ query.transpose(1, 2))


def cqa_from_score(score, video, query, v_mask, q_mask):
    """The [B, T, 4d] concat from a trilinear score (which training forms
    from dropped inputs): masked row and column softmaxes, v2q, q2v."""
    score_q = torch.softmax(mask_logits(score, q_mask[:, None, :]), dim=-1)
    score_v = torch.softmax(mask_logits(score, v_mask[:, :, None]), dim=1)
    v2q = score_q @ query
    q2v = score_q @ (score_v.transpose(1, 2) @ video)
    return torch.cat([video, v2q, video * v2q, video * q2v], dim=-1)


# the most CTAs a row cqa_plan takes
CQA_CTAS = 64
CQA_THREADS = 512  # csrc/cqa.cu kThreads


def _cqa_smem_bytes(frames, W, D):
    """csrc/cqa.cu CqaLayout's bytes for `frames` frames a CTA and a query
    of W words: v [frames, D], q and the partial A [W, D] each, the column
    maxima and sums and q.w4q [W] each, S [frames, W] and v.w4v
    [frames]."""
    return 4 * (frames * D + 2 * W * D + 3 * W + frames * W + frames)


def cqa_part_floats(W, D):
    """A CTA's partials in the workspace between the two launches: A [W,
    D], the column maxima and sums [W] each, rounded up to 16 bytes."""
    return -(-(W * D + 2 * W) // 4) * 4


def cqa_max_words(frames, D):
    """The longest query whose CTA of `frames` frames fits a block."""
    return (MAX_SMEM_BYTES // 4 - frames * D - frames) // (2 * D + 3 + frames)


class CQAPlan(NamedTuple):
    """One call of the CQA kernel: `n` CTAs a batch row, CTA r taking the
    frames [r * frames, min(T, (r + 1) * frames)); `smem` bytes a CTA,
    `ctas` = B * n."""
    n: int
    frames: int
    smem: int
    ctas: int


def cqa_plan(B, T, W, D):
    """The CQA kernel's launch plan for B rows of T frames and W words of
    width D: two launches (on the card they beat one launch of a cluster a
    row at the paths' shapes, PERF.md) on enough CTAs a row that the B rows
    fill the card's SMs once (16 of 64 frames at path L's [8, 1024]; 8 of
    16 at the served [16, 128]), none of them empty, or more CTAs, up to
    CQA_CTAS, where the frames' shared memory does not fit: v [frames, D]
    and S [frames, W] beside q and A [W, D] cap W at 154 words at D = 128
    and 64 frames, 185 at 32, 203 at 16 (cqa_max_words). Raises beyond the
    limit at CQA_CTAS CTAs a row, naming it, and on what the kernel cannot
    take."""
    if B < 1 or T < 1 or W < 1 or D < 4 or D % 4:
        raise ValueError("cqa_plan: needs B, T, W >= 1 and D %% 4 == 0, got "
                         "B=%d, T=%d, W=%d, D=%d" % (B, T, W, D))
    top = min(CQA_CTAS, T)
    for n in range(max(1, min(top, N_SMS // B)), top + 1):
        frames = -(-T // n)
        smem = _cqa_smem_bytes(frames, W, D)
        if smem <= MAX_SMEM_BYTES:
            break
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            "cqa_plan: a query of W=%d words at T=%d, D=%d needs %d bytes of "
            "shared memory a CTA of %d frames, above the %d a block has: W "
            "up to %d fits" % (W, T, D, smem, frames, MAX_SMEM_BYTES,
                               cqa_max_words(frames, D)))
    n = -(-T // frames)  # no empty CTA
    return CQAPlan(n, frames, smem, B * n)


def fused_cqa_concat(video, query, v_mask, q_mask, w4v, w4q, w4mul):
    """[B, T, 4d] CQA concat (no score: the kernel never writes it out), on
    cqa_plan, which raises for a query too long for it."""
    name = "cqa_concat_fwd"
    if not _on_cuda(name, video, query, v_mask, q_mask, w4v, w4q, w4mul):
        return cqa_plain(video, query, v_mask, q_mask, w4v, w4q, w4mul)[0]
    B, T, D = video.shape
    W = query.shape[1]
    plan = cqa_plan(B, T, W, D)
    _check(name, video, (B, T, D))
    _check(name, query, (B, W, D))
    _check(name, v_mask, (B, T))
    _check(name, q_mask, (B, W))
    for w in (w4v, w4q, w4mul):
        _check(name, w, (D,))
    # q lands by 16-byte cp.async, v is read as float4s
    video, query = _aligned16(video, query)
    dev = video.device
    out = _empty(dev, B, T, 4 * D)
    parts = _empty(dev, plan.ctas * cqa_part_floats(W, D))
    sq = _empty(dev, B * T * W)
    _launch(name, video.data_ptr(), query.data_ptr(), v_mask.data_ptr(),
            q_mask.data_ptr(), w4v.data_ptr(), w4q.data_ptr(),
            w4mul.data_ptr(), out.data_ptr(), parts.data_ptr(), sq.data_ptr(),
            B, T, W, D, plan.n, plan.frames)
    return out


# --- 6. highlight gate -----------------------------------------------------------
# Replaces vslnet_tpu/ops/pallas_kernels.py:_highlight_gate_kernel (via
# fused_highlight_gate). Kernel: csrc/highlight_gate.cu. Bound by bytes (a
# read of x, a write of the gated x); one warp a frame.


def highlight_plain(x, w, b, v_mask):
    """Masked per-frame logits x.w + b [B, T] and their sigmoid scores."""
    logits = mask_logits(x @ w + b, v_mask)
    return logits, torch.sigmoid(logits)


def fused_highlight_gate(x, w, b, v_mask):
    """x [B, T, d], w [d], b [1], v_mask [B, T] -> (x * scores, scores)."""
    name = "highlight_gate_fwd"
    if not _on_cuda(name, x, w, b, v_mask):
        scores = highlight_plain(x, w, b, v_mask)[1]
        return x * scores[:, :, None], scores
    B, T, D = x.shape
    _check(name, x, (B, T, D))
    _check(name, w, (D,))
    _check(name, b, (1,))
    _check(name, v_mask, (B, T))
    gated = torch.empty_like(x)
    scores = torch.empty(B, T, device=x.device, dtype=torch.float32)
    _launch(name, x.data_ptr(), w.data_ptr(), b.data_ptr(), v_mask.data_ptr(),
            gated.data_ptr(), scores.data_ptr(), B * T, D)
    return gated, scores
