"""Hand-written CUDA kernels of the port, with their plain PyTorch versions
and launch counters. The counterpart of the JAX package's
ops/pallas_kernels.py.

Each wrapper below takes the plain version for tensors on the CPU (the
tests) and launches its kernel for tensors on a CUDA device; there it
raises on anything the kernel does not take and never falls back. The
plain versions also serve the model under `use_pallas=off`, and beyond
each wrapper's predicate (`lstm_kernel_fits`, `conv_kernel_fits`,
`mha_kernel_fits`, `cqa_kernel_fits`, `span_decode_kernel_fits`: pure
functions of the shape, read from the plans), where the modules, serve.py
and train/runner.py call them instead of the wrapper, as the JAX package
gates each Pallas kernel on its `*_fits` predicate. The LSTM
recurrence, the conv block, the MHA block and attention have backward
kernels too: on the card their wrappers go through a
`torch.autograd.Function` (`FusedLSTMRecurrence`, `FusedConvBlock`,
`FusedConvBlockTiled`, `FusedConvBlockWide`, `FusedMHABlock`, `FusedMHA`,
`FusedFlashMHA`), on
the CPU through torch's autograd of the plain versions (at bf16 through
their plain twins' Functions, below). The `launch_*`
functions are the kernels alone, for CUDA tensors only: the autograd
Functions call them, and chip_smoke.py times them.

Which kernels a block takes on the card depends on its shape, by the
port's own gates (`conv_route`, `mha_route`, `attention_route`): the
whole-row conv block kernels for rows shorter than the measured crossovers
(24 frames when serving, 48 when training) and the T-tiled ones above;
the MHA block kernels up to T = 145 at D = 128, above that the block's
PyTorch ops around `fused_mha`, whose whole-T kernels take T up to 209 at
head dim 16 and its flash kernels any longer T. At bf16 the conv block at
D = 896 and 1024 and the MHA block at head dim 128 (the JAX bench's
`saturated` widths), which no earlier kernel took, take the wide kernels
(sections 2c and 3c: each layer split at its products, which run over
every frame at once on the tensor cores); at fp32 those shapes stay on
the plain versions.

bf16 (`precision=bf16`): the LSTM recurrence, the conv block (both forms),
the MHA block and attention at any T (whole-T and flash) have bf16 kernels
each way, the TPU kernels' functions at bf16 (bf16 activations, fp32
weights rounded where the TPU kernel rounds them, fp32 accumulation;
`_BF16_KERNELS`). Their wrappers take the activation's dtype and launch
the bf16 entry point for bf16 tensors (counted under its own name); above
the block kernels' T the MHA block at bf16 is the JAX package's unfused
block at bf16 (bf16 residuals) around `fused_mha`'s bf16 kernels. Their
plain versions compute the same bf16 functions. The backward's bf16
function is the JAX package's custom VJP, which rounds at its own points,
not at the transposes of the forward's casts, so torch's autograd of the
forward twin is another function: the backward twins
`lstm_recurrence_bwd_plain`, `conv_block_bwd_plain`, `mha_block_bwd_plain`,
`attention_bwd_plain` and `flash_attention_bwd_plain` write the VJPs out,
and on the CPU a bf16 gradient runs them through `PlainLSTMRecurrence`,
`PlainConvBlock`, `PlainMHABlock`, `PlainMHA` and `PlainFlashMHA` (an fp32
gradient keeps torch's autograd of the forward twins). The other kernels
are fp32 at any precision, as the JAX package's wrappers cast around
them.

The kernels (csrc/*.cu, sm_90a) are compiled with nvcc into one
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
            "mha_fwd": 0, "mha_bwd": 0, "flash_mha_fwd": 0, "flash_mha_bwd": 0,
            "lstm_recurrence_fwd_bf16": 0, "conv_block_fwd_bf16": 0,
            "conv_block_fwd_tiled_bf16": 0, "mha_block_fwd_bf16": 0,
            "lstm_recurrence_fwd_res_bf16": 0, "lstm_recurrence_bwd_bf16": 0,
            "conv_block_bwd_bf16": 0, "conv_block_bwd_tiled_bf16": 0,
            "mha_block_bwd_bf16": 0, "mha_fwd_bf16": 0, "mha_bwd_bf16": 0,
            "flash_mha_fwd_bf16": 0, "flash_mha_bwd_bf16": 0,
            "conv_block_fwd_wide_bf16": 0, "conv_block_bwd_wide_bf16": 0,
            "mha_block_fwd_wide_bf16": 0, "mha_block_bwd_wide_bf16": 0,
            "tc_gemm_bf16": 0, "wgrad_bf16": 0}
# the kernels with a bf16 entry point: a wrapper given bf16 activations
# launches `<name>_bf16`
_BF16_KERNELS = ("lstm_recurrence_fwd", "conv_block_fwd",
                 "conv_block_fwd_tiled", "mha_block_fwd",
                 "lstm_recurrence_fwd_res", "lstm_recurrence_bwd",
                 "conv_block_bwd", "conv_block_bwd_tiled", "mha_block_bwd",
                 "mha_fwd", "mha_bwd", "flash_mha_fwd", "flash_mha_bwd")


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
_SIGNATURES.update({"vsl_%s_bf16" % n: _SIGNATURES["vsl_" + n]
                    for n in _BF16_KERNELS})
# the bf16 LSTM backward also takes a float32 workspace for dk_h's sums
_SIGNATURES["vsl_lstm_recurrence_bwd_bf16"] = [_P] * 11 + [_I] * 8 + [_P]
# the bf16 tiled conv forward takes bf16(wp) in place of wp, writes the
# ReLU mask and takes no product tile; its backward takes that mask,
# bf16(wp) in place of wp and wp^T, and wp's slice for the product tile
_SIGNATURES["vsl_conv_block_fwd_tiled_bf16"] = [_P] * 7 + _DROP + [_P] * 3 + [_I] * 7 + [_P]
_SIGNATURES["vsl_conv_block_bwd_tiled_bf16"] = [_P] * 9 + _DROP + [_P] * 9 + [_I] * 8 + [_P]
# the bf16 whole-row conv forward also writes its backward's residuals (xs
# and the ReLU mask, null when serving); its backward reads them, with the
# tiled backward's arguments but a CTA a row (no frames a tile)
_SIGNATURES["vsl_conv_block_fwd_bf16"] = [_P] * 7 + _DROP + [_P] * 3 + [_I] * 7 + [_P]
_SIGNATURES["vsl_conv_block_bwd_bf16"] = [_P] * 9 + _DROP + [_P] * 9 + [_I] * 7 + [_P]
# the bf16 MHA block backward takes bf16 weights, its slices and key tiles
# and whether its products' A tiles sit in shared memory
_SIGNATURES["vsl_mha_block_bwd_bf16"] = [_P] * 7 + _DROP + [_P] * 15 + [_I] * 9 + [_P]
# the bf16 flash forward takes no query rows a thread
_SIGNATURES["vsl_flash_mha_fwd_bf16"] = [_P] * 5 + _DROP + [_P] * 2 + [_I] * 4 + [_P]
# the wide forms of #2c, #9c, #3b and #10b (bf16 only; bf16 weights in
# place of the fp32 ones, and the workspaces of their split products)
_SIGNATURES.update({
    "vsl_conv_block_fwd_wide_bf16": [_P] * 7 + _DROP + [_P] * 4 + [_I] * 6 + [_P],
    "vsl_conv_block_bwd_wide_bf16": [_P] * 9 + _DROP + [_P] * 10 + [_I] * 7 + [_P],
    "vsl_mha_block_fwd_wide_bf16": [_P] * 9 + _DROP + [_P] * 4 + [_I] * 5 + [_P],
    "vsl_mha_block_bwd_wide_bf16": [_P] * 7 + _DROP + [_P] * 16 + [_I] * 8 + [_P],
    # the two products alone (csrc/gemm.cu)
    "vsl_tc_gemm_bf16": [_P] * 3 + [_I] * 4 + [_P],
    "vsl_wgrad_bf16": [_P] * 4 + [_I] * 5 + [_P],
})


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


def _check(name, t, shape, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError("%s: expected %s, got %s" % (name, dtype, t.dtype))
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


def _act_dtype(name, x):
    """The activation dtype a wrapper takes: float32, or bfloat16 where the
    kernel has a bf16 entry point."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("%s: expected float32 or bfloat16, got %s"
                        % (name, x.dtype))
    return x.dtype


def _entry(name, dtype):
    """The kernel's entry point (and launch count) for activations of
    `dtype`."""
    return name + "_bf16" if dtype == torch.bfloat16 else name


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


def depthwise(x, dw):
    """x [B, T, D] convolved along T by the taps dw [k, D], one filter a
    channel, with SAME zero padding."""
    k, D = dw.shape
    xt = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
    return F.conv1d(xt, dw.t().unsqueeze(1), groups=D).transpose(1, 2)


def depthwise_separable(x, dw, wp, bp):
    """relu(pointwise(depthwise(x)) + bp): x [B, T, D], dw [k, D] along T
    with SAME zero padding, wp [D, D], bp [D]."""
    return torch.relu(depthwise(x, dw) @ wp + bp)


def _attention_scores(q, k, v, mask, n_heads, seeds, drop_rate,
                      dtype=torch.float32):
    """(out [B, T, D], the masked scores s [B, H, T, T]) of `attention`."""
    B, T, D = q.shape
    hd = D // n_heads

    def split(t):
        return t.reshape(B, T, n_heads, hd).transpose(1, 2)

    def rnd(t):  # a rounding point at dtype, held in q's dtype
        return t.to(dtype).to(q.dtype)

    scale = float(torch.tensor(1.0 / math.sqrt(float(hd)),
                               dtype=torch.float64).to(dtype))
    s = rnd(split(q) * scale).float() @ split(k).float().transpose(-1, -2)
    s = s + (1.0 - mask.to(torch.float32)).reshape(B, 1, 1, T) * -1e30
    p = torch.softmax(s, dim=-1)
    if drop_rate > 0.0:
        if seeds is None:
            raise ValueError("drop_rate > 0 needs per-row seeds [B, 1]")
        bits = torch.stack([mha_hash_bits(seeds, h, T)
                            for h in range(n_heads)], dim=1)
        p = _drop_bits(p, bits, drop_rate)
    return (rnd(p) @ split(v)).transpose(1, 2).reshape(B, T, D), s


def attention(q, k, v, mask, n_heads, seeds=None, drop_rate=0.0,
              dtype=torch.float32):
    """Multi-head attention without an output projection: q, k, v [B, T, D],
    key mask [B, T] added as (1 - m) * -1e30, fp32 softmax, then each
    head's probabilities dropped by its counter hash (at (t, j) of the
    head's [T, T] tile). At dtype bf16 (q, k, v holding bf16 values), the
    JAX package's casts (pallas_kernels.py:662, 1697): q_h times the scale,
    both bf16, rounded to bf16; fp32 scores and softmax; the probabilities
    rounded to bf16 for their product with v_h. The products sum in q's
    dtype: float32 for the bf16 MHA block kernel's function, bf16 for the
    XLA path's (whole_attention_plain: float32 sums and a bf16 output)."""
    return _attention_scores(q, k, v, mask, n_heads, seeds, drop_rate,
                             dtype)[0]


# --- 1. LSTM recurrence --------------------------------------------------------
# Replaces vslnet_tpu/ops/pallas_kernels.py:_lstm_fwd_lean_kernel,
# _lstm_fwd_kernel and _lstm_bwd_kernel (via fused_lstm_recurrence and its
# VJP). Kernels: csrc/lstm.cu. The forwards run as thread-block clusters
# (lstm_plan): each CTA keeps its slice of k_h in shared memory for all T
# steps and sends its slice of the new h to every CTA of the cluster
# through distributed shared memory, so a step is bound by its on-chip
# dot product, gate math and exchange latency, not by L2. The backward runs
# on the same plan in reverse: each CTA keeps its units' k_h rows in shared
# memory and sends its slice of each step's dgates to every CTA. At bf16
# both directions run on the tensor cores, on the same clusters with k_h
# as mma fragments in registers (lstm_fwd_bf16_plan, lstm_bwd_bf16_plan).

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


LSTM_MAX_H = 256  # the widest hidden size csrc/lstm.cu is built for


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
    if not 1 <= H <= LSTM_MAX_H or B < 1:
        raise ValueError("lstm_plan: needs 1 <= H <= %d and B >= 1, got "
                         "B=%d, H=%d" % (LSTM_MAX_H, B, H))
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


# the k16 steps of K a warp of the bf16 backward takes (csrc/lstm.cu
# kTcBwdKSteps): its k_h fragments live in registers
LSTM_TC_KSTEPS = 8


class LSTMBwdBf16Plan(NamedTuple):
    """One launch of the bf16 backward on the tensor cores (csrc/lstm.cu
    lstm_bwd_tc_kernel): clusters of `n` CTAs, each owning `units` hidden
    units (a multiple of 8; the gates padded to n * units) of `bt` batch
    rows, `threads` a CTA (4 warps a 16 units, each warp LSTM_TC_KSTEPS
    k16 steps of K = 4 n units), `smem` bytes of dynamic shared memory
    (csrc/lstm.cu TcBwdLayout), `clusters` = ceil(B / bt)."""
    n: int
    bt: int
    units: int
    threads: int
    smem: int
    clusters: int


def lstm_bwd_bf16_plan(B, H):
    """The bf16 backward's plan for B rows of hidden size H: lstm_plan's
    clusters and rows, with the units a CTA rounded up to a multiple of 8
    (a CTA's share of a gate's bf16 dgates is whole 16-byte chunks) and the
    cluster cut to the CTAs that hold a unit. Shared memory: two
    mbarriers, the dgates [2, 8, 16 warps LSTM_TC_KSTEPS] bf16 at
    _tc_stride, the warps' partials [warps, 16 ceil(units / 16), 8]
    float."""
    if not 1 <= H <= LSTM_MAX_H or B < 1:
        raise ValueError("lstm_bwd_bf16_plan: needs 1 <= H <= %d and B >= 1, "
                         "got B=%d, H=%d" % (LSTM_MAX_H, B, H))
    units = -(-H // min(LSTM_CLUSTER, H) // 8) * 8
    n = -(-H // units)
    bt = lstm_plan(B, H).bt
    m_tiles = -(-units // 16)
    warps = 4 * m_tiles
    smem = (16 + 2 * 8 * _tc_stride(16 * warps * LSTM_TC_KSTEPS) * 2
            + warps * m_tiles * 16 * 8 * 4)
    return LSTMBwdBf16Plan(n, bt, units, 32 * warps, smem, -(-B // bt))


# units a warp of the bf16 forward takes (csrc/lstm.cu kTcFwdWarpUnits): its
# m16 mma tile holds their four gates
LSTM_FWD_TC_WARP_UNITS = 4


class LSTMFwdBf16Plan(NamedTuple):
    """One launch of the bf16 forwards on the tensor cores (csrc/lstm.cu
    lstm_fwd_tc_kernel): clusters of `n` CTAs, each owning `units` hidden
    units (a multiple of 8; h padded to n * units) of `bt` batch rows,
    `threads` a CTA (a warp a LSTM_FWD_TC_WARP_UNITS units, its m16 tile
    their four gates), `ksteps` k16 steps of h's padded width (a power of
    two, the kernel's template), `smem` bytes of dynamic shared memory
    (csrc/lstm.cu TcFwdLayout), `clusters` = ceil(B / bt)."""
    n: int
    bt: int
    units: int
    threads: int
    ksteps: int
    smem: int
    clusters: int


def lstm_fwd_bf16_plan(B, H):
    """The bf16 forwards' plan for B rows of hidden size H: the backward's
    geometry (lstm_bwd_bf16_plan: lstm_plan's clusters and rows, units a
    CTA a multiple of 8), a warp a LSTM_FWD_TC_WARP_UNITS of the units.
    Shared memory: two mbarriers and bf16(h) [2, 8, 16 ksteps] at
    _tc_stride."""
    if not 1 <= H <= LSTM_MAX_H or B < 1:
        raise ValueError("lstm_fwd_bf16_plan: needs 1 <= H <= %d and B >= 1, "
                         "got B=%d, H=%d" % (LSTM_MAX_H, B, H))
    bwd = lstm_bwd_bf16_plan(B, H)
    ksteps = 1 << max(0, (-(-bwd.n * bwd.units // 16) - 1).bit_length())
    smem = 16 + 2 * 8 * _tc_stride(16 * ksteps) * 2
    return LSTMFwdBf16Plan(bwd.n, bwd.bt, bwd.units,
                           32 * bwd.units // LSTM_FWD_TC_WARP_UNITS, ksteps,
                           smem, bwd.clusters)


def lstm_recurrence_plain(x_proj, k_h, valid, state_dtype=torch.float32,
                          residuals=False):
    """[T, B, 4H] pre-projected inputs, [H, 4H] recurrent kernel, [T, B]
    validity -> [T, B, H] in state_dtype; TF gates [i, j, f, o], forget
    bias 1, state frozen and output zeroed where valid is 0. Its gradient
    is torch's autograd through the loop. The gate math and the carried c
    and h are in state_dtype, and h is rounded to k_h's dtype for its
    product: with bf16 x_proj and k_h, float32 gives the bf16 kernel's
    function (pallas_kernels.py:241-269 at bf16: bf16(h) . k_h with fp32
    accumulation, fp32 gates, state and output) and bf16 the JAX package's
    lax.scan (vslnet_tpu/models/layers.py LSTMEncoder: all of it bf16).
    With residuals, (out, acts [T, B, 4H], tanh(c~), c_prev, h_prev [T, B,
    H]): the residual forward's outputs (`_lstm_fwd_kernel`), what
    lstm_recurrence_bwd_plain reads."""
    T, B, G = x_proj.shape
    H = G // 4
    act = k_h.dtype
    x_proj, k_h, valid = (t.to(state_dtype) for t in (x_proj, k_h, valid))
    h = x_proj.new_zeros(B, H)
    c = x_proj.new_zeros(B, H)
    outs, res = [], []
    for t in range(T):
        gates = x_proj[t] + h.to(act).to(state_dtype) @ k_h
        i, j, f, o = gates.split(H, dim=-1)
        v = valid[t][:, None]
        ig, jg, fg, og = (torch.sigmoid(i), torch.tanh(j),
                          torch.sigmoid(f + 1.0), torch.sigmoid(o))
        new_c = c * fg + ig * jg
        th = torch.tanh(new_c)
        new_h = th * og
        if residuals:
            res.append((torch.cat([ig, jg, fg, og], dim=-1), th, c, h))
        c = v * new_c + (1.0 - v) * c
        out = v * new_h
        h = out + (1.0 - v) * h
        outs.append(out)
    if residuals:
        return (torch.stack(outs), *(torch.stack(r) for r in zip(*res)))
    return torch.stack(outs)


def lstm_recurrence_bwd_plain(dy, acts, th, c_prev, h_prev, valid, k_h,
                              work=torch.float32):
    """The reverse recurrence, written out as `_lstm_bwd_kernel` and
    `_fused_lstm_bwd` compute it (pallas_kernels.py:316-375, 550-557):
    dy [T, B, H] and the residual forward's float32 outputs -> (dx_proj
    [T, B, 4H], dk_h [H, 4H]) in k_h's dtype. The gate backward, dh and dc
    are float32; at bf16 the dgates are rounded for their products, dh +=
    bf16(dgates) . k_h^T and dk_h = sum_t bf16(h_prev)^T . bf16(dgates)
    (fp32 sums), and dx_proj (the fp32 dgates) and dk_h are rounded to
    bf16 at the end. At float32 it is the fp32 kernel's function. `work`
    float64 evaluates the same function, its rounding points kept, with
    every other value in float64 and the outputs left in float64
    (bench/tc_bwd_fp64.py)."""
    T, B, H = dy.shape
    act, f32 = k_h.dtype, work

    def rnd(t):  # a rounding point at k_h's dtype, held in `work`
        return t.to(act).to(f32)

    kh = k_h.to(f32)
    dy, acts, th, c_prev, h_prev, valid = (
        t.to(f32) for t in (dy, acts, th, c_prev, h_prev, valid))
    dh = dy.new_zeros(B, H)
    dc = dy.new_zeros(B, H)
    dkh = kh.new_zeros(H, 4 * H)
    dxp = [None] * T
    for t in range(T - 1, -1, -1):
        v = valid[t][:, None]
        i, g, f, o = acts[t].split(H, dim=-1)
        dh_t = v * (dy[t] + dh)
        dh_pass = (1.0 - v) * dh
        dc_t = v * dc + dh_t * o * (1.0 - th[t] * th[t])
        dc_pass = (1.0 - v) * dc
        dgates = torch.cat([(dc_t * g) * i * (1.0 - i),
                            (dc_t * i) * (1.0 - g * g),
                            (dc_t * c_prev[t]) * f * (1.0 - f),
                            (dh_t * th[t]) * o * (1.0 - o)], dim=-1)
        dxp[t] = dgates
        dg = rnd(dgates)
        dh = dh_pass + dg @ kh.t()
        dc = dc_pass + dc_t * f
        dkh = dkh + rnd(h_prev[t]).t() @ dg
    if work != torch.float32:
        return torch.stack(dxp), dkh
    return torch.stack(dxp).to(act), dkh.to(act)


def _lstm_shapes(name, x_proj, k_h, valid, dtype=torch.float32):
    """(T, B, H, the plan's ints for csrc/lstm.cu): the forward's shapes
    checked (x_proj and k_h in `dtype`), then planned: lstm_plan's (n, bt,
    splits, threads), at bf16 lstm_fwd_bf16_plan's (n, bt, units,
    threads)."""
    T, B, G = x_proj.shape
    H = G // 4
    if G != 4 * H or not 1 <= H <= 256 or B < 1:
        raise ValueError("%s: needs x_proj [T, B, 4H] with B >= 1 and H <= "
                         "256, got %s" % (name, tuple(x_proj.shape)))
    _check(name, x_proj, (T, B, 4 * H), dtype)
    _check(name, k_h, (H, 4 * H), dtype)
    _check(name, valid, (T, B))
    if dtype == torch.bfloat16:
        p = lstm_fwd_bf16_plan(B, H)
        return T, B, H, (p.n, p.bt, p.units, p.threads)
    plan = lstm_plan(B, H)
    return T, B, H, (plan.n, plan.bt, plan.splits, plan.threads)


def launch_lstm_fwd(x_proj, k_h, valid):
    """The lean forward kernel (no residuals), its bf16 entry point for bf16
    x_proj and k_h; the output is float32 either way. CUDA tensors only."""
    dtype = _act_dtype("lstm_recurrence_fwd", x_proj)
    name = _entry("lstm_recurrence_fwd", dtype)
    T, B, H, plan = _lstm_shapes(name, x_proj, k_h, valid, dtype)
    _require_cuda(name, x_proj, k_h, valid)
    out = _empty(x_proj.device, T, B, H)
    _launch(name, x_proj.data_ptr(), k_h.data_ptr(), valid.data_ptr(),
            out.data_ptr(), T, B, H, *plan)
    return out


def launch_lstm_fwd_res(x_proj, k_h, valid):
    """The forward kernel with residuals: (out, acts [T, B, 4H], tanh(c~),
    c_prev, h_prev [T, B, H]), its bf16 entry point for bf16 x_proj and
    k_h; the outputs are float32 either way. CUDA tensors only."""
    dtype = _act_dtype("lstm_recurrence_fwd_res", x_proj)
    name = _entry("lstm_recurrence_fwd_res", dtype)
    T, B, H, plan = _lstm_shapes(name, x_proj, k_h, valid, dtype)
    _require_cuda(name, x_proj, k_h, valid)
    dev = x_proj.device
    out, th, c_prev, h_prev = (_empty(dev, T, B, H) for _ in range(4))
    acts = _empty(dev, T, B, 4 * H)
    _launch(name, x_proj.data_ptr(), k_h.data_ptr(), valid.data_ptr(),
            out.data_ptr(), acts.data_ptr(), th.data_ptr(), c_prev.data_ptr(),
            h_prev.data_ptr(), T, B, H, *plan)
    return out, acts, th, c_prev, h_prev


def launch_lstm_bwd(dy, acts, th, c_prev, h_prev, valid, k_h):
    """The reverse recurrence and dk_h: (dx_proj [T, B, 4H], dk_h [H, 4H])
    in k_h's dtype, the bf16 entry point for bf16 k_h (dy and the residuals
    float32 either way). CUDA tensors only."""
    dtype = _act_dtype("lstm_recurrence_bwd", k_h)
    name = _entry("lstm_recurrence_bwd", dtype)
    _require_cuda(name, dy, acts, th, c_prev, h_prev, valid, k_h)
    T, B, H = dy.shape
    for t, shape in ((dy, (T, B, H)), (acts, (T, B, 4 * H)), (th, (T, B, H)),
                     (c_prev, (T, B, H)), (h_prev, (T, B, H)), (valid, (T, B))):
        _check(name, t, shape)
    _check(name, k_h, (H, 4 * H), dtype)
    if not 1 <= H <= 256 or B < 1:
        raise ValueError("%s: needs dy [T, B, H] with B >= 1 and H <= 256, "
                         "got %s" % (name, tuple(dy.shape)))
    if dtype == torch.bfloat16:
        p = lstm_bwd_bf16_plan(B, H)
        plan = (p.n, p.bt, p.units, p.threads)
    else:
        p = lstm_plan(B, H)
        plan = (p.n, p.bt, p.splits, p.threads)
    dev = dy.device
    dxp = torch.empty(T, B, 4 * H, device=dev, dtype=dtype)
    dkh = torch.empty(H, 4 * H, device=dev, dtype=dtype)
    # the tensor-core dk_h product (bf16) in blocks that fill the SMs twice
    splits = _wgrad_splits(1, H, 4 * H, T * B,
                           2 if dtype == torch.bfloat16 else 1)
    ws = _empty(dev, splits * H * 4 * H if splits > 1 else 1)
    # at bf16 dk_h is summed in float32, then rounded
    dkh32 = [_empty(dev, H, 4 * H).data_ptr()] if dtype == torch.bfloat16 \
        else []
    _launch(name, dy.data_ptr(), acts.data_ptr(), th.data_ptr(),
            c_prev.data_ptr(), h_prev.data_ptr(), valid.data_ptr(),
            k_h.data_ptr(), dxp.data_ptr(), dkh.data_ptr(), *dkh32,
            ws.data_ptr(), splits, T, B, H, *plan)
    return dxp, dkh


class FusedLSTMRecurrence(torch.autograd.Function):
    """The recurrence on the card: the residual forward kernel, then the
    reverse kernel in backward (`fused_lstm_recurrence`'s VJP); at either
    dtype."""

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


class PlainLSTMRecurrence(torch.autograd.Function):
    """FusedLSTMRecurrence's plain twin: the forward twin with residuals,
    then lstm_recurrence_bwd_plain, the JAX package's VJP written out (at
    bf16 not torch's autograd of the forward twin, which rounds elsewhere).
    What the CPU runs for a bf16 gradient."""

    @staticmethod
    def forward(ctx, x_proj, k_h, valid):
        out, *res = lstm_recurrence_plain(x_proj, k_h, valid, residuals=True)
        ctx.save_for_backward(*res, valid, k_h)
        return out

    @staticmethod
    def backward(ctx, dy):
        return (*lstm_recurrence_bwd_plain(dy, *ctx.saved_tensors), None)


def fused_lstm_recurrence(x_proj, k_h, valid):
    """On the card: the lean kernel where no gradient is needed, else
    FusedLSTMRecurrence, at the activations' dtype. On the CPU: the plain
    version, through PlainLSTMRecurrence for a bf16 gradient (torch's
    autograd of the plain version at fp32)."""
    name = "lstm_recurrence_fwd"
    grad = grad_wanted(x_proj, k_h)
    if not _on_cuda(name, x_proj, k_h, valid):
        if grad and x_proj.dtype == torch.bfloat16:
            return PlainLSTMRecurrence.apply(x_proj, k_h, valid)
        return lstm_recurrence_plain(x_proj, k_h, valid)
    _act_dtype(name, x_proj)
    if grad:
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


def conv_block_plain(x, gam, beta, dw, wp, bp, seeds=None, drop_rate=0.0,
                     residual_dtype=torch.float32):
    """L x {x + drop(relu(pointwise(depthwise(LN(x))) + bp))}: x [B, T, D],
    gam/beta/bp [L, D], dw [L, k, D], wp [L, D, D]; layer l's dropout is the
    counter hash with salt 0x100 + l and the row seeds [B, 1]. The residual
    stream and each stage are in residual_dtype, with LN(x) and the
    pointwise product's inputs rounded to x's dtype: with bf16 x, float32
    gives the bf16 kernels' function (pallas_kernels.py:985-1034 at bf16:
    an fp32 residual stream, n = LN(x) rounded to bf16, the fp32
    depthwise, bf16(d) . bf16(wp) with fp32 accumulation, the output
    rounded to bf16 once) and bf16 the JAX package's XLA path (every stage
    and the residual bf16)."""
    act, dt = x.dtype, residual_dtype

    def rnd(t):  # a rounding point at x's dtype, held in residual_dtype
        return t.to(act).to(dt)

    x = x.to(dt)
    for l in range(gam.shape[0]):
        d = depthwise(rnd(layer_norm(x, gam[l], beta[l])), dw[l].to(dt))
        r = torch.relu(rnd(d) @ rnd(wp[l]) + bp[l].to(dt))
        x = x + site_dropout(r, seeds, 0x100 + l, drop_rate)
    return x.to(act)


def relu_mask_bits(p):
    """[p > 0] of p [..., D] packed as the bf16 kernels store it, [..., D /
    4] uint8: bit q of byte c the column 4 c + q."""
    bits = (p > 0).reshape(*p.shape[:-1], p.shape[-1] // 4, 4).to(torch.uint8)
    return (bits * torch.tensor([1, 2, 4, 8], dtype=torch.uint8,
                                device=p.device)).sum(dim=-1, dtype=torch.uint8)


def conv_block_residuals_plain(x, gam, beta, dw, wp, bp, seeds=None,
                               drop_rate=0.0):
    """conv_block_plain with the residuals the bf16 whole-row forward saves
    for its backward: (out, xs [L - 1, B, T, D] float32, the inputs of
    layers 1..L-1, mask [L, B, T, D / 4] uint8, each layer's [p > 0] as
    relu_mask_bits packs it), from conv_block_replay at x's dtype; xs holds
    one unused layer where L = 1."""
    saved = conv_block_replay(x, gam, beta, dw, wp, bp, seeds, drop_rate)
    xl, xs = x.float(), []
    for l, (_, _, _, _, p) in enumerate(saved):
        xs.append(xl)
        xl = xl + site_dropout(torch.relu(p), seeds, 0x100 + l, drop_rate)
    xs = torch.stack(xs[1:]) if len(xs) > 1 else torch.zeros_like(xl)[None]
    return (xl.to(x.dtype), xs,
            torch.stack([relu_mask_bits(s[4]) for s in saved]))


def _ln_stats(x):
    """(xh, inv) of the JAX package's _ln_fwd: x - mean times inv =
    rsqrt(population variance + 1e-6), over the last dim."""
    mean = x.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((x - mean).square().mean(dim=-1, keepdim=True) + 1e-6)
    return (x - mean) * inv, inv


def _ln_bwd(gn, gam, xh, inv):
    """The JAX package's _ln_bwd over [B, T, D]: (dx, dgam, dbeta), the
    parameter gradients summed over rows and positions."""
    dxh = gn * gam
    dx = inv * (dxh - dxh.mean(dim=-1, keepdim=True)
                - xh * (dxh * xh).mean(dim=-1, keepdim=True))
    return dx, (gn * xh).sum(dim=(0, 1)), gn.sum(dim=(0, 1))


def depthwise_t(g, dw):
    """The transpose of `depthwise` in its input: g [B, T, D] -> [B, T, D],
    out[t] = sum_j g[t + pad - j] dw[j], pad = (k - 1) // 2."""
    k, D = dw.shape
    gt = F.pad(g.transpose(1, 2), (k // 2, (k - 1) // 2))
    return F.conv1d(gt, dw.flip(0).t().unsqueeze(1), groups=D).transpose(1, 2)


def conv_layer_replay(xl, gam, beta, dw, wp, bp, act):
    """One layer of the conv block's replay from its input xl (float32, or
    float64 for an fp64 evaluation), rounded at act as the kernels round:
    (n, xh, inv, d, p), p the pre-ReLU."""
    work = xl.dtype

    def rnd(t):
        return t.to(act).to(work)

    gam, beta, dw, wp, bp = (w.to(work) for w in (gam, beta, dw, wp, bp))
    xh, inv = _ln_stats(xl)
    n = xh * gam + beta
    d = rnd(depthwise(rnd(n), dw))
    return n, xh, inv, d, d @ rnd(wp) + bp


def conv_block_replay(x, gam, beta, dw, wp, bp, seeds, drop_rate,
                      work=torch.float32):
    """conv_block_bwd_plain's replay of conv_block_plain in `work` (rounded
    at x's dtype): each layer's conv_layer_replay, in order."""
    xl = x.to(work)
    saved = []
    for l in range(gam.shape[0]):
        saved.append(conv_layer_replay(xl, gam[l], beta[l], dw[l], wp[l],
                                       bp[l], x.dtype))
        xl = xl + site_dropout(torch.relu(saved[-1][4]), seeds, 0x100 + l,
                               drop_rate)
    return saved


def conv_block_bwd_plain(x, gam, beta, dw, wp, bp, seeds, drop_rate, g,
                         work=torch.float32):
    """The conv block's backward, written out as
    `_make_conv_block_bwd_kernel` computes it (pallas_kernels.py:1039-1114):
    a float32 replay of conv_block_plain (rounded at x's dtype), then for
    each layer in reverse, with the running gradient G float32 (g in x's
    dtype): g_p = [p > 0] drop(G), dbp = sum g_p (unrounded), dwp = sum
    bf16(d)^T . bf16(g_p), g_d = bf16(g_p) . bf16(wp)^T, the fp32 depthwise
    transpose g_n and ddw from the UNROUNDED LayerNorm output n (the
    forward's depthwise read bf16(n)), the fp32 LayerNorm backward, G +=
    dx_ln; dx = G rounded to x's dtype once, after layer 0. -> (dx, dgam,
    dbeta [L, D], ddw [L, k, D], dwp [L, D, D], dbp [L, D]), the weight
    gradients float32. At float32 it is the fp32 kernel's function. `work`
    float64 evaluates the same function, its rounding points kept, with
    every other value in float64 and the outputs left in float64
    (bench/tc_bwd_fp64.py)."""
    act, f32 = x.dtype, work

    def rnd(t):  # a rounding point at x's dtype, held in `work`
        return t.to(act).to(f32)

    L, K, D = dw.shape
    pad = (K - 1) // 2
    saved = conv_block_replay(x, gam, beta, dw, wp, bp, seeds, drop_rate,
                              f32)
    wp, dw, gam = wp.to(f32), dw.to(f32), gam.to(f32)
    G = g.to(f32)
    grads = []
    for l in range(L - 1, -1, -1):
        n, xh, inv, d, p = saved[l]
        g_p = torch.where(p > 0.0, site_dropout(G, seeds, 0x100 + l,
                                                drop_rate), 0.0)
        gp_t = rnd(g_p)
        dwp = d.reshape(-1, D).t() @ gp_t.reshape(-1, D)
        g_d = gp_t @ rnd(wp[l]).t()
        n_p = F.pad(n, (0, 0, pad, K - 1 - pad))
        T = n.shape[1]
        ddw = torch.stack([(n_p[:, j:j + T] * g_d).sum(dim=(0, 1))
                           for j in range(K)])
        dx_ln, dgam, dbeta = _ln_bwd(depthwise_t(g_d, dw[l]), gam[l], xh, inv)
        G = G + dx_ln
        grads.append((dgam, dbeta, ddw, dwp, g_p.sum(dim=(0, 1))))
    dgam, dbeta, ddw, dwp, dbp = (torch.stack(t[::-1]) for t in zip(*grads))
    return G.to(act) if work == torch.float32 else G, dgam, dbeta, ddw, dwp, dbp


class PlainConvBlock(torch.autograd.Function):
    """FusedConvBlock's plain twin: conv_block_plain, then
    conv_block_bwd_plain (at bf16 not torch's autograd of the forward twin,
    which rounds elsewhere). What the CPU runs for a bf16 gradient."""

    @staticmethod
    def forward(ctx, x, gam, beta, dw, wp, bp, seeds, drop_rate):
        ctx.save_for_backward(x, gam, beta, dw, wp, bp, seeds)
        ctx.drop_rate = drop_rate
        return conv_block_plain(x, gam, beta, dw, wp, bp, seeds, drop_rate)

    @staticmethod
    def backward(ctx, g):
        x, gam, beta, dw, wp, bp, seeds = ctx.saved_tensors
        return (*conv_block_bwd_plain(x, gam, beta, dw, wp, bp, seeds,
                                      ctx.drop_rate, g), None, None)


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


def _conv_shapes(name, x, gam, beta, dw, wp, bp, smem, dtype=torch.float32):
    B, T, D = x.shape
    L, K, _ = dw.shape
    if D % 4:
        raise ValueError("%s: needs D %% 4 == 0, got D=%d" % (name, D))
    if smem > MAX_SMEM_BYTES:
        raise ValueError("%s: T=%d, D=%d needs %d bytes of shared memory, "
                         "above the %d a block has" % (name, T, D, smem,
                                                       MAX_SMEM_BYTES))
    _check(name, x, (B, T, D), dtype)
    for t in (gam, beta, bp):
        _check(name, t, (L, D))
    _check(name, dw, (L, K, D))
    _check(name, wp, (L, D, D))
    return B, T, D, L, K


def _aligned16(*tensors):
    """The tensors, each copied where it does not start on 16 bytes: the
    conv and MHA block kernels copy their weights by 16-byte cp.async."""
    return [a if a.data_ptr() % 16 == 0 else a.clone() for a in tensors]


def launch_conv_block_fwd(x, gam, beta, dw, wp, bp, seeds=None, drop_rate=0.0,
                          residuals=False):
    """The forward kernel on conv_fwd_plan's CTAs, its bf16 entry point for
    bf16 x (out in x's dtype): CUDA tensors only. With residuals (bf16 x,
    a gradient to follow) (out, xs, mask), what the bf16 backward reads:
    xs [L - 1, B, T, D] float32, the inputs of layers 1..L-1, and mask [L,
    B, T, D / 4] uint8, each layer's [p > 0] (conv_block_residuals_plain's
    function)."""
    name = _entry("conv_block_fwd", _act_dtype("conv_block_fwd", x))
    _require_cuda(name, x, gam, beta, dw, wp, bp)
    B, T, D, L, K = _conv_shapes(name, x, gam, beta, dw, wp, bp, 0, x.dtype)
    if residuals and x.dtype != torch.bfloat16:
        raise ValueError("%s: the residuals are the bf16 forward's" % name)
    plan = conv_fwd_plan(B, T, D, K, L)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    dw, wp = _aligned16(dw, wp)
    out = torch.empty_like(x)
    args = [x.data_ptr(), gam.data_ptr(), beta.data_ptr(), dw.data_ptr(),
            wp.data_ptr(), bp.data_ptr(), sp, thresh, scale, out.data_ptr()]
    if x.dtype == torch.bfloat16:
        xs = mask = None
        if residuals:
            xs = _empty(x.device, max(L - 1, 1), B, T, D)
            mask = torch.empty(L, B, T, D // 4, device=x.device,
                               dtype=torch.uint8)
        args += [0 if xs is None else xs.data_ptr(),
                 0 if mask is None else mask.data_ptr()]
    _launch(name, *args, B, T, D, L, K, plan.n, plan.frames)
    return (out, xs, mask) if residuals else out


class ConvBwdBf16Plan(NamedTuple):
    """One call of the bf16 whole-row conv backward on the tensor cores:
    `ctas` = B CTAs of CONV_TILED_THREADS threads, a row each, `frames` =
    T, `smem` bytes, bf16(wp)'s rows in slices of `slice` (a multiple of 16
    dividing D rounded up to 64)."""
    frames: int
    slice: int
    smem: int
    ctas: int


@functools.lru_cache(maxsize=256)
def conv_bwd_bf16_plan(B, T, D, K, L):
    """The bf16 whole-row backward's launch plan (csrc/conv_block.cu
    conv_block_bwd_tc_row_kernel): the T-tiled tensor-core backward's
    layer with the whole row as its tile, one CTA a row through every
    layer, bf16(wp)'s rows whole in shared memory where they fit, else in
    the largest slices that do (_conv_tiled_bwd_bf16_smem_bytes at T
    frames). At the query stream's [16, 12, 128]: 16 CTAs of ~72 KB. It
    takes every shape conv_route sends to "block" with a gradient. Raises
    on what the kernel cannot take."""
    if B < 1 or T < 1 or K < 1 or L < 1 or D < 4 or D % 4:
        raise ValueError("conv_bwd_bf16_plan: needs B, T, K, L >= 1 and D %% "
                         "4 == 0, got B=%d, T=%d, D=%d, K=%d, L=%d"
                         % (B, T, D, K, L))
    dk = -(-D // 64) * 64
    sn = next((sn for sn in range(dk, 15, -16) if dk % sn == 0
               and _conv_tiled_bwd_bf16_smem_bytes(T, D, K, sn)
               <= MAX_SMEM_BYTES), None)
    if sn is None:
        raise ValueError("conv_bwd_bf16_plan: T=%d, D=%d needs %d bytes of "
                         "shared memory a row, above the %d a block has"
                         % (T, D, _conv_tiled_bwd_bf16_smem_bytes(T, D, K, 16),
                            MAX_SMEM_BYTES))
    return ConvBwdBf16Plan(T, sn, _conv_tiled_bwd_bf16_smem_bytes(T, D, K, sn),
                           B)


def launch_conv_block_bwd(x, gam, beta, dw, wp, bp, seeds, drop_rate, g,
                          xs=None, mask=None, wpb=None):
    """The backward kernel: (dx, dgam, dbeta, ddw, dwp, dbp), the weight
    gradients summed over the batch; the bf16 entry point for bf16 x (g and
    dx in x's dtype, the weight gradients float32 either way), on
    conv_bwd_bf16_plan, which reads the bf16 forward's residuals xs and
    mask (launch_conv_block_fwd with residuals) and, where the caller has
    it, the forward's bf16(wp) wpb. CUDA tensors only."""
    name = _entry("conv_block_bwd", _act_dtype("conv_block_bwd", x))
    if x.dtype == torch.bfloat16:
        return _launch_conv_block_bwd_bf16(x, xs, mask, gam, beta, dw, wp, bp,
                                           seeds, drop_rate, g, wpb)
    _require_cuda(name, x, gam, beta, dw, wp, bp, g)
    B, T, D, L, K = _conv_shapes(name, x, gam, beta, dw, wp, bp, 0, x.dtype)
    plan = conv_plan(B, T, D, K, L)
    _check(name, g, (B, T, D), x.dtype)
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


def _launch_conv_block_bwd_bf16(x, xs, mask, gam, beta, dw, wp, bp, seeds,
                                drop_rate, g, wpb=None):
    """launch_conv_block_bwd for bf16 x: the tensor-core kernel
    (csrc/conv_block.cu conv_block_bwd_tc_row_kernel) on
    conv_bwd_bf16_plan, reading the forward's layer inputs and ReLU
    masks; raises without them (no replay)."""
    name = "conv_block_bwd_bf16"
    if xs is None or mask is None:
        raise ValueError("%s: needs the bf16 forward's residuals xs and mask "
                         "(launch_conv_block_fwd with residuals)" % name)
    _require_cuda(name, x, xs, mask, gam, beta, dw, wp, bp, g)
    B, T, D, L, K = _conv_shapes(name, x, gam, beta, dw, wp, bp, 0, x.dtype)
    plan = conv_bwd_bf16_plan(B, T, D, K, L)
    _check(name, xs, (max(L - 1, 1), B, T, D))
    _check(name, mask, (L, B, T, D // 4), torch.uint8)
    _check(name, g, (B, T, D), x.dtype)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    dev = x.device
    # x, g, xs and the taps are read as float4s (or 8 bytes of bf16) and by
    # cp.async; bf16(wp), the function's rounding of wp, by 8-byte cp.async
    x, g, dw, bp = _aligned16(x, g, dw, bp)
    wpb = _bf16_of(name, wp, wpb)
    dx = torch.empty_like(x)
    dsmall = _empty(dev, L, 3 + K, D)
    dwp = _empty(dev, L, D, D)
    # dwp's operands bf16(d) and bf16(g_p), and the running gradient between
    # the layers in two float32 buffers, dx only layer 0's output
    d_ws, gp_ws = (torch.empty(L, B, T, D, device=dev, dtype=torch.bfloat16)
                   for _ in range(2))
    g_ws = _empty(dev, 2, B, T, D)
    part = _empty(dev, B, L, 3 + K, D)
    splits = _wgrad_splits(L, D, D, B * T, CONV_TILED_WGRAD_WAVES)
    ws = _empty(dev, L * splits * D * D if splits > 1 else 1)
    _launch(name, x.data_ptr(), xs.data_ptr(), mask.data_ptr(), gam.data_ptr(),
            beta.data_ptr(), dw.data_ptr(), wpb.data_ptr(), bp.data_ptr(), sp,
            thresh, scale, g.data_ptr(), dx.data_ptr(), dsmall.data_ptr(),
            dwp.data_ptr(), d_ws.data_ptr(), gp_ws.data_ptr(), g_ws.data_ptr(),
            part.data_ptr(), ws.data_ptr(), splits, B, T, D, L, K, plan.slice)
    return dx, dsmall[:, 0], dsmall[:, 1], dsmall[:, 3:], dwp, dsmall[:, 2]


class FusedConvBlock(torch.autograd.Function):
    """The conv block on the card: forward kernel, backward kernel; at
    bf16 the forward keeps the backward's residuals (each layer's input and
    ReLU mask) and one rounding of wp a step, read by both."""

    @staticmethod
    def forward(ctx, x, gam, beta, dw, wp, bp, seeds, drop_rate):
        saved = []
        if x.dtype == torch.bfloat16:
            out, xs, mask = launch_conv_block_fwd(x, gam, beta, dw, wp, bp,
                                                  seeds, drop_rate, True)
            saved = [xs, mask, wp.to(torch.bfloat16).contiguous()]
        else:
            out = launch_conv_block_fwd(x, gam, beta, dw, wp, bp, seeds,
                                        drop_rate)
        ctx.save_for_backward(x, gam, beta, dw, wp, bp, seeds, *saved)
        ctx.drop_rate = drop_rate
        return out

    @staticmethod
    def backward(ctx, g):
        x, gam, beta, dw, wp, bp, seeds, *saved = ctx.saved_tensors
        grads = launch_conv_block_bwd(x, gam, beta, dw, wp, bp, seeds,
                                      ctx.drop_rate, g.contiguous(), *saved)
        return (*grads, None, None)


def fused_conv_block(x, gam, beta, dw, wp, bp, seeds=None, drop_rate=0.0):
    """On the card: the whole-row kernels or the T-tiled ones, as
    conv_route says for a call that takes a gradient (training) or not
    (serving), at x's dtype; the backward is its forward's route's. On the
    CPU: the plain version, through PlainConvBlock for a bf16 gradient."""
    name = "conv_block_fwd"
    tensors = [x, gam, beta, dw, wp, bp] + ([] if seeds is None else [seeds])
    grad = grad_wanted(*tensors)
    args = (x, gam, beta, dw, wp, bp, seeds, float(drop_rate))
    if not _on_cuda(name, *tensors):
        if grad and x.dtype == torch.bfloat16:
            return PlainConvBlock.apply(*args)
        return conv_block_plain(x, gam, beta, dw, wp, bp, seeds, drop_rate)
    L, K, _ = dw.shape
    route = conv_route(*x.shape[1:], K, L, grad, x.dtype)
    if not grad:
        return {"block": launch_conv_block_fwd,
                "tiled": lambda *a: launch_conv_block_fwd_tiled(*a)[0],
                "wide": lambda *a: launch_conv_block_fwd_wide(*a)[0]}[route](
                    *args)
    return {"block": FusedConvBlock, "tiled": FusedConvBlockTiled,
            "wide": FusedConvBlockWide}[route].apply(*args)


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


def conv_route(T, D, K, L, grad=False, dtype=torch.float32):
    """"block" (the whole-row forward, the backward a cluster a row) for
    rows shorter than CONV_TILED_FWD_T frames, or CONV_TILED_PAIR_T where a
    backward follows (grad), and where the whole-row kernels fit: the
    route's T limit and conv_plan's CTAs; else "tiled". The T limit is the
    one the whole-row backward had when it was one block a row: three
    [T, D] rows, T inverse deviations and 16 D floats of LN reductions in a
    block's shared memory (T <= 145 at D = 128). At bf16 a shape that
    neither of those pairs takes goes "wide" where conv_wide_plan takes it
    (D = 896 and 1024); every shape they take keeps its route."""
    if (dtype == torch.bfloat16 and not _conv_pair_fits(T, D, K, L, grad)
            and _plans_take((conv_wide_plan, 1, T, D, K, L))):
        return "wide"
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


def _conv_tiled_bwd_bf16_smem_bytes(frames, D, K, sn):
    """csrc/conv_block.cu TcTiledBwdLayout's bytes for `frames` frames a
    tile and slices of `sn` of bf16(wp)'s rows."""
    dk = -(-D // 64) * 64
    e = frames + K - 1
    return (4 * (2 * e * D + frames * D + K * D + -(-frames // 4) * 4)
            + 2 * (-(-e // 16) * 16 + sn) * _tc_stride(dk))


class ConvTiledBwdBf16Plan(NamedTuple):
    """One call of the bf16 tiled conv backward on the tensor cores: each of
    L launches on `ctas` = B * `tiles` CTAs of CONV_TILED_THREADS threads, a
    CTA taking `frames` frames of a row (tiles = ceil(T / frames)) and
    `smem` bytes, bf16(wp)'s rows in slices of `slice` (a multiple of 16
    dividing D rounded up to 64)."""
    frames: int
    tiles: int
    slice: int
    smem: int
    ctas: int


@functools.lru_cache(maxsize=256)
def conv_tiled_bwd_bf16_plan(B, T, D, K, L):
    """The bf16 tiled backward's launch plan, chosen as conv_tiled_bwd_plan
    chooses its tiles (the F of CONV_TILED_FRAMES, cut to T, of the fewest
    waves times ceil((F + K - 1) / 4), the larger F on a tie) with wp's rows
    whole in shared memory where they fit, else in the largest slices that
    do. At path L's [8, 1024, 128]: 128 CTAs of 64 frames (~161 KB each);
    at path M's [16, 192, 128], 128 of 24. Raises on what the kernel cannot
    take."""
    if B < 1 or T < 1 or K < 1 or L < 1 or D < 4 or D % 4:
        raise ValueError("conv_tiled_bwd_bf16_plan: needs B, T, K, L >= 1 and "
                         "D %% 4 == 0, got B=%d, T=%d, D=%d, K=%d, L=%d"
                         % (B, T, D, K, L))
    dk = -(-D // 64) * 64
    best = None
    for frames in sorted({min(T, f) for f in CONV_TILED_FRAMES}):
        sn = next((sn for sn in range(dk, 15, -16) if dk % sn == 0
                   and _conv_tiled_bwd_bf16_smem_bytes(frames, D, K, sn)
                   <= MAX_SMEM_BYTES), None)
        if sn is None:
            continue
        tiles = -(-T // frames)
        cost = -(-B * tiles // N_SMS) * -(-(frames + K - 1) // 4)
        if best is None or cost <= best[0]:
            best = (cost, ConvTiledBwdBf16Plan(
                frames, tiles, sn,
                _conv_tiled_bwd_bf16_smem_bytes(frames, D, K, sn), B * tiles))
    if best is None:
        frames = min(T, CONV_TILED_FRAMES[0])
        raise ValueError("conv_tiled_bwd_bf16_plan: D=%d needs %d bytes of "
                         "shared memory a tile of %d frames, above the %d a "
                         "block has" % (D, _conv_tiled_bwd_bf16_smem_bytes(
                             frames, D, K, 16), frames, MAX_SMEM_BYTES))
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


def _conv_tiled_fwd_bf16_smem_bytes(frames, D, K, sn):
    """csrc/conv_block.cu TcTiledFwdLayout's bytes for `frames` frames a
    tile and slices of `sn` of bf16(wp)'s columns: x_l's window, n_l's and
    the taps in fp32, the bf16 A tile [frames rounded up to 16][_tc_stride(
    Dk)] and the slice [Dk][_tc_stride(sn)], Dk = D rounded up to 64."""
    dk = -(-D // 64) * 64
    return (4 * (2 * (frames + K - 1) * D + K * D)
            + 2 * (-(-frames // 16) * 16 * _tc_stride(dk) + dk * _tc_stride(sn)))


class ConvTiledFwdBf16Plan(NamedTuple):
    """One call of the bf16 tiled conv forward on the tensor cores: each of
    L launches on `ctas` = B * `tiles` CTAs of CONV_TILED_THREADS threads, a
    CTA taking `frames` frames of a row (tiles = ceil(T / frames)) and
    `smem` bytes, bf16(wp)'s columns in slices of `slice` (a multiple of
    16; ceil(D / slice) slices)."""
    frames: int
    tiles: int
    slice: int
    smem: int
    ctas: int


@functools.lru_cache(maxsize=256)
def conv_tiled_fwd_bf16_plan(B, T, D, K, L):
    """The bf16 tiled forward's launch plan, its tiles chosen as
    conv_tiled_fwd_plan chooses them (the F of CONV_TILED_FRAMES, cut to T,
    of the fewest waves times F + K - 1, the larger F on a tie), with
    bf16(wp)'s columns whole in shared memory where they fit, else in the
    widest slices of 16 columns that do. At path L's [8, 1024, 128]: 128
    CTAs of 64 frames (~125 KB each); at path M's [16, 192, 128], 128 of 24;
    at [16, 128, 128], 128 of 16. Raises on what the kernel cannot take."""
    if B < 1 or T < 1 or K < 1 or L < 1 or D < 4 or D % 4:
        raise ValueError("conv_tiled_fwd_bf16_plan: needs B, T, K, L >= 1 and "
                         "D %% 4 == 0, got B=%d, T=%d, D=%d, K=%d, L=%d"
                         % (B, T, D, K, L))
    dn = -(-D // 16) * 16
    best = None
    for frames in sorted({min(T, f) for f in CONV_TILED_FRAMES}):
        sn = next((sn for sn in range(dn, 15, -16)
                   if _conv_tiled_fwd_bf16_smem_bytes(frames, D, K, sn)
                   <= MAX_SMEM_BYTES), None)
        if sn is None:
            continue
        tiles = -(-T // frames)
        cost = -(-B * tiles // N_SMS) * (frames + K - 1)
        if best is None or cost <= best[0]:
            best = (cost, ConvTiledFwdBf16Plan(
                frames, tiles, sn,
                _conv_tiled_fwd_bf16_smem_bytes(frames, D, K, sn), B * tiles))
    if best is None:
        frames = min(T, CONV_TILED_FRAMES[0])
        raise ValueError("conv_tiled_fwd_bf16_plan: D=%d needs %d bytes of "
                         "shared memory a tile of %d frames, above the %d a "
                         "block has" % (D, _conv_tiled_fwd_bf16_smem_bytes(
                             frames, D, K, 16), frames, MAX_SMEM_BYTES))
    return best[1]


def _bf16_of(name, w, wb):
    """bf16(w), the function's rounding of a weight: wb where the caller
    made it (checked against w's shape), else made here."""
    if wb is None:
        return w.to(torch.bfloat16).contiguous()
    _check(name, wb, w.shape, torch.bfloat16)
    return wb


def launch_conv_block_fwd_tiled(x, gam, beta, dw, wp, bp, seeds=None,
                                drop_rate=0.0, wpb=None):
    """The tiled forward kernels on conv_tiled_fwd_plan: (out, xs [L - 1, B,
    T, D], the inputs of layers 1..L-1, which the tiled backward reads);
    for bf16 x the bf16 entry point, the tensor-core kernels on
    conv_tiled_fwd_bf16_plan (out in x's dtype, xs float32 either way),
    which also returns each layer's ReLU mask [p > 0] for the bf16
    backward: (out, xs, mask [L, B, T, D / 4] uint8, bit q of byte c the
    column 4 c + q). At bf16, wpb is bf16(wp) where the caller has it
    (FusedConvBlockTiled hands the backward the same one), else made here.
    CUDA tensors only; raises where the tiled backward's plan does not fit
    either."""
    name = "conv_block_fwd_tiled"
    bf16 = _act_dtype(name, x) == torch.bfloat16
    name = _entry(name, x.dtype)
    _require_cuda(name, x, gam, beta, dw, wp, bp)
    B, T, D, L, K = _conv_shapes(name, x, gam, beta, dw, wp, bp, 0, x.dtype)
    plan = (conv_tiled_fwd_bf16_plan if bf16 else conv_tiled_fwd_plan)(
        B, T, D, K, L)
    (conv_tiled_bwd_bf16_plan if bf16 else conv_tiled_bwd_plan)(B, T, D, K, L)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    # x, the taps and the weights land by 16-byte cp.async (bf16(wp), the
    # function's rounding of wp, made once a call, too), x and bp are read
    # as float4s (bp as float2s at bf16)
    x, dw, wp, bp = _aligned16(x, dw, wp, bp)
    out = torch.empty_like(x)
    xs = _empty(x.device, max(L - 1, 1), B, T, D)
    if not bf16:
        _launch(name, x.data_ptr(), gam.data_ptr(), beta.data_ptr(),
                dw.data_ptr(), wp.data_ptr(), bp.data_ptr(), sp, thresh, scale,
                xs.data_ptr(), out.data_ptr(), B, T, D, L, K, plan.frames,
                plan.slice, plan.product_rows)
        return out, xs
    wpb = _bf16_of(name, wp, wpb)
    mask = torch.empty(L, B, T, D // 4, device=x.device, dtype=torch.uint8)
    _launch(name, x.data_ptr(), gam.data_ptr(), beta.data_ptr(), dw.data_ptr(),
            wpb.data_ptr(), bp.data_ptr(), sp, thresh, scale, xs.data_ptr(),
            mask.data_ptr(), out.data_ptr(), B, T, D, L, K, plan.frames,
            plan.slice)
    return out, xs, mask


def launch_conv_block_bwd_tiled(x, xs, gam, beta, dw, wp, bp, seeds,
                                drop_rate, g, mask=None, wpb=None):
    """The tiled backward kernels on conv_tiled_bwd_plan, from the forward's
    xs: (dx, dgam, dbeta, ddw, dwp, dbp), the weight gradients summed over
    the batch; for bf16 x the bf16 entry point on conv_tiled_bwd_bf16_plan,
    which also takes the forward's ReLU `mask` and, where the caller has
    it, the forward's bf16(wp) `wpb` (g and dx in x's dtype, xs,
    the gradient between the layers and the weight gradients float32).
    CUDA tensors only."""
    name = "conv_block_bwd_tiled"
    if _act_dtype(name, x) == torch.bfloat16:
        return _launch_conv_block_bwd_tiled_bf16(x, xs, mask, gam, beta, dw,
                                                 wp, bp, seeds, drop_rate, g,
                                                 wpb)
    _require_cuda(name, x, xs, gam, beta, dw, wp, bp, g)
    B, T, D, L, K = _conv_shapes(name, x, gam, beta, dw, wp, bp, 0, x.dtype)
    plan = conv_tiled_bwd_plan(B, T, D, K, L)
    _check(name, xs, (max(L - 1, 1), B, T, D))
    _check(name, g, (B, T, D), x.dtype)
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
    # the running gradient between the layers: dx and g_ws in turns
    g_ws = _empty(dev, 1, B, T, D)
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


def _launch_conv_block_bwd_tiled_bf16(x, xs, mask, gam, beta, dw, wp, bp,
                                      seeds, drop_rate, g, wpb=None):
    """launch_conv_block_bwd_tiled for bf16 x: the tensor-core kernels
    (csrc/conv_block.cu conv_layer_bwd_tc_tiled_kernel) on
    conv_tiled_bwd_bf16_plan, reading the forward's ReLU mask."""
    name = "conv_block_bwd_tiled_bf16"
    if mask is None:
        raise ValueError("%s: needs the bf16 tiled forward's ReLU mask" % name)
    _require_cuda(name, x, xs, mask, gam, beta, dw, wp, bp, g)
    B, T, D, L, K = _conv_shapes(name, x, gam, beta, dw, wp, bp, 0, x.dtype)
    plan = conv_tiled_bwd_bf16_plan(B, T, D, K, L)
    _check(name, xs, (max(L - 1, 1), B, T, D))
    _check(name, mask, (L, B, T, D // 4), torch.uint8)
    _check(name, g, (B, T, D), x.dtype)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    dev = x.device
    # x, g, xs and the taps are read as float4s (or 8 bytes of bf16) and by
    # cp.async; bf16(wp), the function's rounding of wp, by 8-byte cp.async
    x, g, dw, bp = _aligned16(x, g, dw, bp)
    wpb = _bf16_of(name, wp, wpb)
    dx = torch.empty_like(x)
    dsmall = _empty(dev, L, 3 + K, D)
    dwp = _empty(dev, L, D, D)
    # dwp's operands bf16(d) and bf16(g_p), and the running gradient between
    # the layers in two float32 buffers, dx only layer 0's output
    d_ws, gp_ws = (torch.empty(L, B, T, D, device=dev, dtype=torch.bfloat16)
                   for _ in range(2))
    g_ws = _empty(dev, 2, B, T, D)
    part = _empty(dev, plan.ctas, L, 3 + K, D)
    splits = _wgrad_splits(L, D, D, B * T, CONV_TILED_WGRAD_WAVES)
    ws = _empty(dev, L * splits * D * D if splits > 1 else 1)
    _launch(name, x.data_ptr(), xs.data_ptr(), mask.data_ptr(), gam.data_ptr(),
            beta.data_ptr(), dw.data_ptr(), wpb.data_ptr(), bp.data_ptr(), sp,
            thresh, scale, g.data_ptr(), dx.data_ptr(), dsmall.data_ptr(),
            dwp.data_ptr(), d_ws.data_ptr(), gp_ws.data_ptr(), g_ws.data_ptr(),
            part.data_ptr(), ws.data_ptr(), splits, B, T, D, L, K, plan.frames,
            plan.slice)
    return dx, dsmall[:, 0], dsmall[:, 1], dsmall[:, 3:], dwp, dsmall[:, 2]


class FusedConvBlockTiled(torch.autograd.Function):
    """The conv block on the card at any T: the tiled forward kernels, which
    keep each layer's input, then the tiled backward kernels."""

    @staticmethod
    def forward(ctx, x, gam, beta, dw, wp, bp, seeds, drop_rate):
        # at bf16 one rounding of wp a step, read by both directions
        wpb = (wp.to(torch.bfloat16).contiguous()
               if x.dtype == torch.bfloat16 else None)
        out, xs, *mask = launch_conv_block_fwd_tiled(x, gam, beta, dw, wp, bp,
                                                     seeds, drop_rate, wpb)
        ctx.save_for_backward(x, xs, gam, beta, dw, wp, bp, seeds, wpb, *mask)
        ctx.drop_rate = drop_rate
        return out

    @staticmethod
    def backward(ctx, g):
        x, xs, gam, beta, dw, wp, bp, seeds, wpb, *mask = ctx.saved_tensors
        grads = launch_conv_block_bwd_tiled(x, xs, gam, beta, dw, wp, bp, seeds,
                                            ctx.drop_rate, g.contiguous(),
                                            *mask, wpb=wpb)
        return (*grads, None, None)


# --- the wide kernels' bf16 products on Hopper's wgmma ----------------------------
# csrc/mma.cuh tc_gemm and wgrad_wg (wg_gemm_kernel): C = A . B (or A . B^T,
# or the split-K A[z]^T . B[z]) on tiles of 128 x 128 of C, bf16 operands
# brought into a ring of shared memory by TMA and multiplied by
# wgmma.mma_async, fp32 sums: chains of GEMM_CHAIN k16 steps in the tensor
# cores, each added to the sums by fp32 adds. The wide kernels (#2c, #9c,
# #3b, #10b wide) run every product on them from their own entry points;
# launch_tc_gemm_bf16 and launch_wgrad_bf16 run the two alone (the card
# tests, chip_smoke.py).

# the kernel's tiles of C, stages of k, ring, chain, threads and registers
# by role (kGemmM, kGemmN, kGemmK, kGemmStages, kGemmChain, kGemmThreads,
# kGemmProducerRegs, kGemmConsumerRegs): a producer warpgroup and two
# consumer warpgroups, one CTA an SM (the consumers' 64 sums and 64 chain
# values a thread fill the registers), a persistent grid
GEMM_M = 128
GEMM_N = 128
GEMM_K = 64
GEMM_STAGES = 6
GEMM_CHAIN = 4
GEMM_THREADS = 384
GEMM_PRODUCER_REGS = 40
GEMM_CONSUMER_REGS = 232
GEMM_STAGE_BYTES = 2 * (GEMM_M + GEMM_N) * GEMM_K
GEMM_CHAIN_STAGES = GEMM_CHAIN * 16 // GEMM_K
# the registers of one SM
SM_REGISTERS = 65536
# the card's bf16 tensor-core peak and memory rate (NVIDIA's H100 SXM data
# sheet): the split plan's time of a stage and of a partial's bytes
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def _gemm_smem_bytes():
    """csrc/mma.cuh gemm_smem_bytes: the ring, its full and empty mbarriers
    and the slack that aligns the ring to 1024 bytes."""
    return 1024 + GEMM_STAGES * GEMM_STAGE_BYTES + 2 * GEMM_STAGES * 8


def tc_gemm_fits(M, N, K):
    """csrc/mma.cuh tc_gemm_ok for contiguous rows: whole tiles of columns
    and whole stages of k."""
    return M >= 1 and N >= GEMM_N and N % GEMM_N == 0 and K >= GEMM_K \
        and K % GEMM_K == 0


def wgrad_wg_fits(Z, M, N, K):
    """csrc/mma.cuh wgrad_wg_ok: whole tiles of C, any K."""
    return Z >= 1 and K >= 1 and M >= GEMM_M and M % GEMM_M == 0 \
        and N >= GEMM_N and N % GEMM_N == 0


def _wgrad_chunk(kts, S):
    """csrc/mma.cuh wgrad_wg: stages of k a split, whole chains."""
    c = GEMM_CHAIN_STAGES
    return -(-(-(-kts // S)) // c) * c


@functools.lru_cache(maxsize=256)
def wgrad_splits(Z, M, N, K):
    """Splits of K for wgrad_wg's items: the S whose last CTA ends soonest,
    with every split holding stages. Each of the card's N_SMS CTAs takes
    items in turn, an item a tile and a split of chunk stages, a stage at
    the bf16 peak's share of one SM; the partials beyond S = 1 are written
    once and read once more by sum_partials at the memory rate."""
    tiles = Z * (M // GEMM_M) * (N // GEMM_N)
    kts = -(-K // GEMM_K)
    stage_s = 2 * GEMM_M * GEMM_N * GEMM_K / (PEAK_BF16_FLOPS / N_SMS)
    best = None
    for S in range(1, max(1, -(-kts // GEMM_CHAIN_STAGES)) + 1):
        chunk = _wgrad_chunk(kts, S)
        if -(-kts // chunk) != S:
            continue
        waves = -(-tiles * S // N_SMS)
        partials = (2 * S + 1) * Z * M * N * 4 if S > 1 else 0
        cost = waves * chunk * stage_s + partials / HBM_BYTES_PER_S
        if best is None or cost < best[0]:
            best = (cost, S)
    return best[1]


class _NoTF32:
    """float32 products in full float32 inside the block."""

    def __enter__(self):
        self.was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.was


def tc_gemm_plain(a, b, bt=False):
    """C = a . b (b [K, N]) or, with bt, a . b^T (b [N, K]), the bf16
    operands in float32: the plain version of launch_tc_gemm_bf16."""
    with _NoTF32():
        b32 = b.float()
        return torch.matmul(a.float(), b32.t() if bt else b32)


def wgrad_plain(a, b):
    """C[z] = a[z]^T . b[z] (a [Z, K, M], b [Z, K, N]), the bf16 operands in
    float32: the plain version of launch_wgrad_bf16."""
    with _NoTF32():
        return torch.matmul(a.float().transpose(1, 2), b.float())


def launch_tc_gemm_bf16(a, b, bt=False):
    """tc_gemm with an fp32 store: a [M, K], b [K, N] (or with bt [N, K])
    bf16 -> C [M, N] fp32. CUDA tensors launch the kernel, CPU tensors take
    tc_gemm_plain."""
    name = "tc_gemm_bf16"
    if not _on_cuda(name, a, b):
        return tc_gemm_plain(a, b, bt)
    M, K = a.shape
    N = b.shape[0] if bt else b.shape[1]
    if not tc_gemm_fits(M, N, K):
        raise ValueError("%s: needs N a multiple of %d and K of %d, got M=%d, "
                         "N=%d, K=%d" % (name, GEMM_N, GEMM_K, M, N, K))
    _check(name, a, (M, K), torch.bfloat16)
    _check(name, b, (N, K) if bt else (K, N), torch.bfloat16)
    a, b = _aligned16(a, b)
    c = _empty(a.device, M, N)
    _launch(name, a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K, int(bt))
    return c


def launch_wgrad_bf16(a, b, splits=None):
    """wgrad_wg: a [Z, K, M], b [Z, K, N] bf16 -> C [Z, M, N] fp32 = a[z]^T .
    b[z], K in `splits` splits (wgrad_splits' by default) summed in a fixed
    order. CUDA tensors launch the kernel, CPU tensors take wgrad_plain."""
    name = "wgrad_bf16"
    if not _on_cuda(name, a, b):
        return wgrad_plain(a, b)
    Z, K, M = a.shape
    N = b.shape[2]
    if not wgrad_wg_fits(Z, M, N, K):
        raise ValueError("%s: needs M and N multiples of %d, got Z=%d, M=%d, "
                         "N=%d, K=%d" % (name, GEMM_M, Z, M, N, K))
    _check(name, a, (Z, K, M), torch.bfloat16)
    _check(name, b, (Z, K, N), torch.bfloat16)
    S = wgrad_splits(Z, M, N, K) if splits is None else splits
    if S < 1:
        raise ValueError("%s: splits must be at least 1, got %d" % (name, S))
    a, b = _aligned16(a, b)
    c = _empty(a.device, Z, M, N)
    ws = _empty(a.device, Z * S * M * N if S > 1 else 1)
    _launch(name, a.data_ptr(), b.data_ptr(), c.data_ptr(), ws.data_ptr(), Z, M,
            N, K, S)
    return c


# --- 2c. the bf16 conv block at the widths the tiled kernels do not take ------
# #2c and #9c at D = 896 and 1024 (the JAX bench's `saturated` hidden 1024;
# csrc/conv_block.cu, the wide kernels): a layer a few launches, its
# per-frame work on CTAs of strips of frames and its products [B T, D] x
# [D, D] over every frame at once on the tensor cores (mma.cuh tc_gemm);
# the per-frame work streamed through per-thread rings of shared memory:
# forward, a d launch a layer; backward, one d launch for every layer and
# one pass a layer.
# The same function as the tiled bf16 pair, the same (out, xs, mask).

# threads a CTA of the MHA backward's g_dpre launch (csrc/common.cuh
# kWideThreads); the products' tiles of 128 columns (mma.cuh kGemmN) want
# D % 128 == 0
WIDE_THREADS = 512
TC_GEMM_N = GEMM_N


def _require_bf16(name, x):
    if x.dtype != torch.bfloat16:
        raise TypeError("%s: takes bf16 x only, got %s" % (name, x.dtype))


# the per-frame launches (csrc/conv_block.cu conv_wide_d_kernel, the
# forward's and the backward's, and conv_wide_pass_kernel): frames a batch
# of the pass's and the d launch's
# streams (kWideBwdFrames, kWideDFrames), the taps they are built for
# (kWideBwdK, the model's), 4 columns a thread, two CTAs an SM (their
# __launch_bounds__)
WIDE_BWD_FRAMES = 2
WIDE_D_FRAMES = 4
WIDE_BWD_K = 7
WIDE_BWD_CTAS_PER_SM = 2


def _wide_bwd_ring(K, F=WIDE_BWD_FRAMES):
    """csrc/conv_block.cu wide_bwd_ring: frames a ring of batches of F
    holds."""
    return 2 * F + 2 * (K - 1 - (K - 1) // 2)


def _conv_wide_pass_bytes(D, K):
    """csrc/conv_block.cu wide_pass_bytes."""
    F = WIDE_BWD_FRAMES
    R = _wide_bwd_ring(K, F)
    return 4 * ((2 * R + 2 * F) * D + R + 2 * (D // 128) * 3 * F)


def _conv_wide_d_bytes(D, K):
    """csrc/conv_block.cu wide_d_bytes."""
    F = WIDE_D_FRAMES
    R = _wide_bwd_ring(K, F)
    return 4 * ((R + 2 * F) * D + 2 * (D // 128) * F)


def _wide_strip(B, T):
    """Frames a per-frame launch's CTA streams: as many strips a row as let B *
    strips CTAs fill the card's WIDE_BWD_CTAS_PER_SM slots an SM once (one
    strip a row from B = 133 on: each strip's reach is loaded twice), strips
    of at least 8 frames, a row's frames shared out evenly."""
    slots = WIDE_BWD_CTAS_PER_SM * N_SMS
    strips = max(1, min(-(-T // 8), slots // B))
    return -(-T // strips)


class ConvWidePlan(NamedTuple):
    """One call of the wide conv kernels: each per-frame launch (the d
    launch a layer forward, once for every layer backward, then a pass a
    layer) on `ctas` = B * `strips` CTAs of `threads` = D / 4 threads (the
    backward's d launch that many for each layer), a CTA streaming `strip`
    frames of a row (strips = ceil(T / strip)), `smem_d` and `smem_pass`
    bytes; the products on mma.cuh's tiles of 128 x 128."""
    strip: int
    strips: int
    ctas: int
    threads: int
    smem_d: int
    smem_pass: int


@functools.lru_cache(maxsize=256)
def conv_wide_plan(B, T, D, K, L):
    """The wide kernels' plan for B rows of [T, D], K taps and L layers: at
    `saturated`'s [256, 128, 1024] whole rows (256 CTAs, two an SM: 88 KB
    and 96 KB of shared memory). Raises where D is not a multiple of 128,
    above 1024 (4 columns a thread of at most 256) or K is not the
    WIDE_BWD_K taps the per-frame launches are built for."""
    if B < 1 or T < 1 or K < 1 or L < 1 or D < TC_GEMM_N or D % TC_GEMM_N:
        raise ValueError("conv_wide_plan: needs B, T, K, L >= 1 and D a "
                         "multiple of %d, got B=%d, T=%d, D=%d, K=%d, L=%d"
                         % (TC_GEMM_N, B, T, D, K, L))
    if K != WIDE_BWD_K or D > 4 * 256:
        raise ValueError("conv_wide_plan: the wide kernels take K=%d taps "
                         "and D up to 1024, got D=%d, K=%d"
                         % (WIDE_BWD_K, D, K))
    strip = _wide_strip(B, T)
    strips = -(-T // strip)
    return ConvWidePlan(strip, strips, B * strips, D // 4,
                        _conv_wide_d_bytes(D, K), _conv_wide_pass_bytes(D, K))


def launch_conv_block_fwd_wide(x, gam, beta, dw, wp, bp, seeds=None,
                               drop_rate=0.0):
    """The wide forward on conv_wide_plan: (out, xs, mask) as
    launch_conv_block_fwd_tiled gives them at bf16. bf16 CUDA tensors
    only."""
    name = "conv_block_fwd_wide_bf16"
    _require_bf16(name, x)
    _require_cuda(name, x, gam, beta, dw, wp, bp)
    B, T, D, L, K = _conv_shapes(name, x, gam, beta, dw, wp, bp, 0, x.dtype)
    plan = conv_wide_plan(B, T, D, K, L)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    # the products read bf16(wp), the function's rounding of wp, by cp.async
    wpb = wp.to(torch.bfloat16).contiguous()
    out = torch.empty_like(x)
    xs = _empty(x.device, max(L - 1, 1), B, T, D)
    mask = torch.empty(L, B, T, D // 4, device=x.device, dtype=torch.uint8)
    d_ws = torch.empty(B, T, D, device=x.device, dtype=torch.bfloat16)
    _launch(name, x.data_ptr(), gam.data_ptr(), beta.data_ptr(), dw.data_ptr(),
            wpb.data_ptr(), bp.data_ptr(), sp, thresh, scale, xs.data_ptr(),
            mask.data_ptr(), out.data_ptr(), d_ws.data_ptr(), B, T, D, L, K,
            plan.strip)
    return out, xs, mask


def launch_conv_block_bwd_wide(x, xs, gam, beta, dw, wp, bp, seeds, drop_rate,
                               g, mask):
    """The wide backward on conv_wide_plan from the wide forward's xs and
    mask: (dx, dgam, dbeta, ddw, dwp, dbp) as launch_conv_block_bwd_tiled
    gives them at bf16. bf16 CUDA tensors only."""
    name = "conv_block_bwd_wide_bf16"
    _require_bf16(name, x)
    _require_cuda(name, x, xs, mask, gam, beta, dw, wp, bp, g)
    B, T, D, L, K = _conv_shapes(name, x, gam, beta, dw, wp, bp, 0, x.dtype)
    plan = conv_wide_plan(B, T, D, K, L)
    _check(name, xs, (max(L - 1, 1), B, T, D))
    _check(name, mask, (L, B, T, D // 4), torch.uint8)
    _check(name, g, (B, T, D), x.dtype)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    dev = x.device
    wpb = wp.to(torch.bfloat16).contiguous()
    dx = torch.empty_like(x)
    dsmall = _empty(dev, L, 3 + K, D)
    dwp = _empty(dev, L, D, D)
    d_ws, gp_ws = (torch.empty(L, B, T, D, device=dev, dtype=torch.bfloat16)
                   for _ in range(2))
    gd_ws = _empty(dev, B, T, D)
    g_ws = _empty(dev, 2, B, T, D)
    part = _empty(dev, plan.ctas, L, 3 + K, D)
    splits = wgrad_splits(L, D, D, B * T)
    ws = _empty(dev, L * splits * D * D if splits > 1 else 1)
    _launch(name, x.data_ptr(), xs.data_ptr(), mask.data_ptr(), gam.data_ptr(),
            beta.data_ptr(), dw.data_ptr(), wpb.data_ptr(), bp.data_ptr(), sp,
            thresh, scale, g.data_ptr(), dx.data_ptr(), dsmall.data_ptr(),
            dwp.data_ptr(), d_ws.data_ptr(), gp_ws.data_ptr(), gd_ws.data_ptr(),
            g_ws.data_ptr(), part.data_ptr(), ws.data_ptr(), splits, B, T, D, L,
            K, plan.strip)
    return dx, dsmall[:, 0], dsmall[:, 1], dsmall[:, 3:], dwp, dsmall[:, 2]


class FusedConvBlockWide(torch.autograd.Function):
    """The bf16 conv block on the card at the wide widths: the wide forward,
    which keeps each layer's input and ReLU mask, then the wide
    backward."""

    @staticmethod
    def forward(ctx, x, gam, beta, dw, wp, bp, seeds, drop_rate):
        out, xs, mask = launch_conv_block_fwd_wide(x, gam, beta, dw, wp, bp,
                                                   seeds, drop_rate)
        ctx.save_for_backward(x, xs, gam, beta, dw, wp, bp, seeds, mask)
        ctx.drop_rate = drop_rate
        return out

    @staticmethod
    def backward(ctx, g):
        x, xs, gam, beta, dw, wp, bp, seeds, mask = ctx.saved_tensors
        grads = launch_conv_block_bwd_wide(x, xs, gam, beta, dw, wp, bp, seeds,
                                           ctx.drop_rate, g.contiguous(), mask)
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


def mha_qkv_plain(x, gam, beta, wqkv, bqkv, seeds=None, drop_rate=0.0,
                  residual_dtype=torch.float32):
    """The MHA block's projection, qkv = drop200(LN1(x)) . Wqkv + bqkv [B,
    T, 3D], rounded at x's dtype where the TPU kernel rounds it (y, Wqkv and
    qkv; fp32 sums) and held in residual_dtype: with bf16 x, the values the
    bf16 forward kernel saves in bf16 (pallas_kernels.py:1700-1708)."""
    act, dt = x.dtype, residual_dtype

    def rnd(t):  # a rounding point at x's dtype, held in residual_dtype
        return t.to(act).to(dt)

    y = site_dropout(layer_norm(x.to(dt), gam[0], beta[0]).to(dt), seeds,
                     0x200, drop_rate)
    return rnd(rnd(y) @ rnd(wqkv) + bqkv.to(dt))


def _mha_block(attend, x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads,
               seeds, drop_rate, residual_dtype=torch.float32):
    act, dt = x.dtype, residual_dtype
    D = x.shape[-1]

    def rnd(t):  # a rounding point at x's dtype, held in residual_dtype
        return t.to(act).to(dt)

    qkv = mha_qkv_plain(x, gam, beta, wqkv, bqkv, seeds, drop_rate, dt)
    x = x.to(dt)
    q, k, v = (t.contiguous() for t in qkv.split(D, dim=-1))
    att = attend(q, k, v, mask, n_heads, seeds, drop_rate)
    res = site_dropout(att, seeds, 0x201, drop_rate) + x
    z = site_dropout(layer_norm(res, gam[1], beta[1]).to(dt), seeds, 0x202,
                     drop_rate)
    out = site_dropout(rnd(z) @ rnd(wd) + bd.to(dt), seeds, 0x203,
                       drop_rate) + res
    return out.to(act)


def mha_block_plain(x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads,
                    seeds=None, drop_rate=0.0, residual_dtype=torch.float32):
    """Pre-LN attention block: x [B, T, D], key mask [B, T], gam/beta [2, D]
    (LN1, LN2), wqkv [D, 3D], bqkv [3D], wd [D, D], bd [D]; counter-hash
    dropout at sites 0x200 (LN1 out), the probabilities, 0x201 (attention
    out), 0x202 (LN2 out) and 0x203 (dense out). The residuals and each
    stage are in residual_dtype, with y, q, k, v, z and the weights
    rounded to x's dtype for their products: with bf16 x, float32 gives the
    bf16 kernel's function (pallas_kernels.py:1689-1746 at bf16: fp32
    LayerNorms and residuals, fp32 accumulation, `attention` at bf16, the
    output rounded to bf16) and bf16 the JAX package's XLA path (bf16
    residuals)."""
    return _mha_block(functools.partial(attention, dtype=x.dtype), x, mask,
                      gam, beta, wqkv, bqkv, wd, bd, n_heads, seeds,
                      drop_rate, residual_dtype)


def mha_block_bwd_plain(x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads,
                        seeds, drop_rate, g, qkv=None, att=None,
                        work=torch.float32, round_ds=True):
    """The MHA block's backward, written out as `_make_mha_block_bwd_kernel`
    computes it (pallas_kernels.py:1762-1858): a float32 replay of
    mha_block_plain (rounded at x's dtype), then, the gradients float32
    unless said (g in x's dtype): g_dpre = drop203(g), dbd = sum g_dpre
    (unrounded), dwd = sum bf16(z)^T . bf16(g_dpre), g_z = bf16(g_dpre) .
    bf16(wd)^T; the LN2 backward, g_res, g_att = drop201(g_res); per head
    gh = bf16(g_att_h), dv = bf16(drop(p))^T . gh, dp = drop(gh . v_h^T),
    ds = p (dp - sum_j dp p), dq = (bf16(ds) . k_h) * scale, dk =
    bf16(ds)^T . bf16(q_h * scale); dbqkv = sum dqkv (unrounded), dwqkv =
    sum bf16(y)^T . bf16(dqkv), g_y = bf16(dqkv) . bf16(wqkv)^T; the LN1
    backward; dx = g_res + g_x_ln rounded to x's dtype. -> (dx, dgam,
    dbeta [2, D], dwqkv [D, 3D], dbqkv [3D], dwd [D, D], dbd [D]). At
    float32 it is the fp32 kernel's function. With qkv [B, T, 3D] and att
    [B, T, D], the forward's saved values (launch_mha_block_fwd's), it
    takes them instead of its replay's, as the backward kernels do. `work`
    float64 evaluates the same function, its rounding points kept, with
    every other value in float64 and dx left in float64
    (bench/tc_bwd_fp64.py). round_ds=False leaves ds unrounded for dq and
    dk: an impostor the card checks must refuse (bench/bf16_vjp.py)."""
    act, f32 = x.dtype, work

    def rnd(t):  # a rounding point at x's dtype, held in `work`
        return t.to(act).to(f32)

    B, T, D = x.shape
    hd = D // n_heads
    scale = float(torch.tensor(1.0 / math.sqrt(float(hd)),
                               dtype=torch.float64).to(act))
    x32 = x.to(f32)
    xh1, inv1 = _ln_stats(x32)
    y_t = rnd(site_dropout(xh1 * gam[0] + beta[0], seeds, 0x200, drop_rate))
    if qkv is None:
        qkv = rnd(y_t @ rnd(wqkv) + bqkv)
    qkv = qkv.to(f32)
    neg = ((1.0 - mask.to(f32)) * -1e30).reshape(B, 1, T)
    heads = []
    for h in range(n_heads):
        q_h, k_h, v_h = (qkv[:, :, i * D + h * hd:i * D + (h + 1) * hd]
                         for i in range(3))
        qs = rnd(q_h * scale)
        p = torch.softmax(qs @ k_h.transpose(1, 2) + neg, dim=-1)
        keep = (mha_hash_bits(seeds, h, T) >= drop_threshold(drop_rate)
                if drop_rate > 0.0 else None)
        heads.append((q_h, k_h, v_h, qs, p, keep))

    def drop_p(a, keep):  # the probabilities' dropout, by the head's bits
        return a if keep is None else torch.where(
            keep, a * (1.0 / (1.0 - drop_rate)), 0.0)

    if att is None:
        att = torch.cat([rnd(drop_p(p, keep)) @ v_h
                         for _, _, v_h, _, p, keep in heads], dim=-1)
    res = site_dropout(att.to(f32), seeds, 0x201, drop_rate) + x32
    xh2, inv2 = _ln_stats(res)
    z_t = rnd(site_dropout(xh2 * gam[1] + beta[1], seeds, 0x202, drop_rate))

    g = g.to(f32)
    g_dpre = site_dropout(g, seeds, 0x203, drop_rate)
    gd_t = rnd(g_dpre)
    dwd = z_t.reshape(-1, D).t() @ gd_t.reshape(-1, D)
    g_z = gd_t @ rnd(wd).t()
    g_res_ln, dgam2, dbeta2 = _ln_bwd(
        site_dropout(g_z, seeds, 0x202, drop_rate), gam[1], xh2, inv2)
    g_res = g + g_res_ln
    g_att = site_dropout(g_res, seeds, 0x201, drop_rate)
    dq, dk, dv = [], [], []
    for h, (q_h, k_h, v_h, qs, p, keep) in enumerate(heads):
        gh = rnd(g_att[:, :, h * hd:(h + 1) * hd])
        dv.append(rnd(drop_p(p, keep)).transpose(1, 2) @ gh)
        dp = drop_p(gh @ v_h.transpose(1, 2), keep)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        ds_t = rnd(ds) if round_ds else ds
        dq.append((ds_t @ k_h) * scale)
        dk.append(ds_t.transpose(1, 2) @ qs)
    dqkv = torch.cat(dq + dk + dv, dim=-1)
    dqkv_t = rnd(dqkv)
    dwqkv = y_t.reshape(-1, D).t() @ dqkv_t.reshape(-1, 3 * D)
    g_y = dqkv_t @ rnd(wqkv).t()
    g_x_ln, dgam1, dbeta1 = _ln_bwd(
        site_dropout(g_y, seeds, 0x200, drop_rate), gam[0], xh1, inv1)
    dx = g_res + g_x_ln
    return (dx.to(act) if work == torch.float32 else dx,
            torch.stack([dgam1, dgam2]),
            torch.stack([dbeta1, dbeta2]), dwqkv, dqkv.sum(dim=(0, 1)), dwd,
            g_dpre.sum(dim=(0, 1)))


class PlainMHABlock(torch.autograd.Function):
    """FusedMHABlock's plain twin: mha_block_plain, then mha_block_bwd_plain
    (at bf16 not torch's autograd of the forward twin, which rounds
    elsewhere). What the CPU runs for a bf16 gradient."""

    @staticmethod
    def forward(ctx, x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads, seeds,
                drop_rate):
        ctx.save_for_backward(x, mask, gam, beta, wqkv, bqkv, wd, bd, seeds)
        ctx.n_heads, ctx.drop_rate = n_heads, drop_rate
        return mha_block_plain(x, mask, gam, beta, wqkv, bqkv, wd, bd,
                               n_heads, seeds, drop_rate)

    @staticmethod
    def backward(ctx, g):
        x, mask, gam, beta, wqkv, bqkv, wd, bd, seeds = ctx.saved_tensors
        dx, dgam, dbeta, dwqkv, dbqkv, dwd, dbd = mha_block_bwd_plain(
            x, mask, gam, beta, wqkv, bqkv, wd, bd, ctx.n_heads, seeds,
            ctx.drop_rate, g)
        return (dx, None, dgam, dbeta, dwqkv, dbqkv, dwd, dbd, None, None,
                None)


def mha_block_unfused(x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads,
                      seeds=None, drop_rate=0.0):
    """The MHA block where the block kernels do not fit (mha_route "whole"
    or "flash"): mha_block_plain's PyTorch LayerNorms, projections,
    residuals and site dropouts (the same per-row seeds, so the same
    masks) around fused_mha, as the JAX package's unfused block keeps them
    in XLA around its fused_mha (layers.py:466-475): the residuals and
    each stage in x's dtype, so at bf16 the XLA path's bf16 block around
    fused_mha's bf16 kernels."""
    return _mha_block(fused_mha, x, mask, gam, beta, wqkv, bqkv, wd, bd,
                      n_heads, seeds, drop_rate, residual_dtype=x.dtype)


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


def mha_route(T, D, n_heads, dtype=torch.float32):
    """The MHA block's kernels on the card: "block" (the fused block
    kernels) up to the route's T limit, where mha_fwd_plan's and
    mha_bwd_plan's tiles also fit; else the unfused block around fused_mha's
    `attention_route`. At bf16 and a head dim of MHA_WIDE_HEAD_DIMS, which
    no earlier kernel took, "block" (the wide block kernels) wherever
    mha_wide_plan takes the shape, with no T limit of its own. The T limit is the one the block backward had when
    it ran one block a row, kept so that every shape takes the route it
    took then: three [T, D] rows, T inverse deviations and 16 D floats of
    LN reductions, or a head's q, k, v and g, three [T] rows and dS [T, T +
    1], in a block's shared memory (T <= 145 at D = 128). The forward of
    that time, one block a row holding (2 D + 1) T floats, lies inside the
    limit. Raises for a head dim no kernel takes at `dtype`."""
    if dtype == torch.bfloat16 and _wide_head_dim(D, n_heads):
        if _plans_take((mha_wide_plan, 1, T, D, n_heads)):
            return "block"
        return attention_route(T, D // n_heads)
    hd = _head_dim("mha_route", D, n_heads)
    t_limit = (max(3 * T * D + T + 16 * D, 4 * T * hd + 3 * T + T * (T + 1))
               * 4 <= MAX_SMEM_BYTES)
    if (t_limit and _mha_fwd_sizes(T, D, hd) is not None
            and _mha_bwd_sizes(T, D, hd) is not None
            and (dtype != torch.bfloat16
                 or _plans_take((mha_bwd_bf16_plan, 1, T, D, n_heads)))):
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


# the bf16 forward's kernels on the tensor cores (csrc/mha_block.cu
# mha_proj_tc_kernel, attn_fwd_tc_kernel): threads a CTA of the two
# projections (kTcProjThreads), frames a projection tile, the column chunks
# a projection CTA may take (the widest whose shared memory fits), the most
# warps of 16 queries an attention CTA (kTcAttnWarps), and the key tiles of
# 16 the attention is built for (T <= 16 of the largest)
MHA_TC_THREADS = 256
MHA_TC_ROWS = 16
MHA_TC_COLS = (128, 64, 32, 16)
MHA_TC_ATTN_WARPS = 8
MHA_TC_KEY_TILES = (1, 2, 4, 8, 16)


class MHAFwdBf16Plan(NamedTuple):
    """One call of the bf16 MHA block forward on the tensor cores: the two
    projections on `tiles` = ceil(B T / rows) tiles of the flattened
    frames, the QKV launch a CTA a (tile, `qkv_cols` of Wqkv's 3D
    columns), the dense launch a (tile, `dense_cols` of Wd's D), `smem_qkv`
    and `smem_dense` bytes; the attention on `q_tiles` = ceil(T / (16
    q_warps)) CTAs a (row, head) of `q_warps` warps, each holding every
    key of the row in `key_tiles` tiles of 16, `smem_attention` bytes."""
    rows: int
    tiles: int
    qkv_cols: int
    dense_cols: int
    smem_qkv: int
    smem_dense: int
    key_tiles: int
    q_warps: int
    q_tiles: int
    smem_attention: int


def _mha_tc_proj_bytes(rows, cols, D):
    """csrc/mha_block.cu tc_proj_bytes: the bf16 operand [rows][_tc_stride(
    Dk)] and the weight's columns [Dk][_tc_stride(cols)], Dk = D rounded up
    to 64."""
    dk = -(-D // 64) * 64
    return 2 * (rows * _tc_stride(dk) + dk * _tc_stride(cols))


def _mha_tc_attn_bytes(hd, key_tiles, warps):
    """csrc/mha_block.cu tc_attn_bytes: k, v [16 key_tiles] and qs [16
    warps] rows of bf16 at _tc_stride(max(hd, 16)), the key terms fp32."""
    return (2 * (2 * 16 * key_tiles + 16 * warps) * _tc_stride(max(hd, 16))
            + 4 * 16 * key_tiles)


@functools.lru_cache(maxsize=256)
def mha_fwd_bf16_plan(B, T, D, n_heads):
    """The bf16 MHA block forward's launch plan for B rows of [T, D] in
    n_heads heads of MHA_HEAD_DIMS: projection tiles of MHA_TC_ROWS frames
    and column chunks of MHA_TC_COLS that fit, no wider than the weight: the
    QKV product's the widest whose CTAs still number half the SMs (else the
    narrowest), the dense product's the widest no wider than that (128 of
    the 384 and 128 columns at [16, 128, 128]: 384 and 128 CTAs; 64 at the
    query stream's [16, 12, 128]: 72 and 24 CTAs, 7% faster than 128 there
    by mha_plans.py --forward --bf16); the attention on key tiles of
    the fewest of MHA_TC_KEY_TILES that hold T and min(8, ceil(T / 16))
    warps (one CTA of 8 warps a (row, head) at T = 128, of 1 at T = 12).
    Raises on what the kernels cannot take: D not a multiple of 8, T above
    16 * MHA_TC_KEY_TILES[-1]."""
    hd = _head_dim("mha_fwd_bf16_plan", D, n_heads)
    if B < 1 or T < 1 or D % 8:
        raise ValueError("mha_fwd_bf16_plan: needs B, T >= 1 and D %% 8 == 0,"
                         " got B=%d, T=%d, D=%d" % (B, T, D))
    nk = -(-T // 16)
    key_tiles = next((k for k in MHA_TC_KEY_TILES if k >= nk), None)
    if key_tiles is None:
        raise ValueError("mha_fwd_bf16_plan: T=%d above the %d keys the "
                         "attention holds" % (T, 16 * MHA_TC_KEY_TILES[-1]))

    tiles = -(-B * T // MHA_TC_ROWS)

    def fit(N, most):  # the widths that fit, no wider than N (rounded up to 16) or most
        return [c for c in MHA_TC_COLS if c <= min(most, max(16, -(-N // 16) * 16))
                and _mha_tc_proj_bytes(MHA_TC_ROWS, c, D) <= MAX_SMEM_BYTES]

    qkv = fit(3 * D, MHA_TC_COLS[0])
    full = [c for c in qkv if tiles * -(-3 * D // c) >= N_SMS // 2]
    qkv_cols = (full or qkv[-1:] or [None])[0]
    dense_cols = qkv_cols and fit(D, qkv_cols)[0]
    if qkv_cols is None:
        raise ValueError("mha_fwd_bf16_plan: D=%d needs %d bytes of shared "
                         "memory a projection tile, above the %d a block has"
                         % (D, _mha_tc_proj_bytes(MHA_TC_ROWS, 16, D),
                            MAX_SMEM_BYTES))
    warps = min(MHA_TC_ATTN_WARPS, nk)
    return MHAFwdBf16Plan(
        MHA_TC_ROWS, tiles, qkv_cols, dense_cols,
        _mha_tc_proj_bytes(MHA_TC_ROWS, qkv_cols, D),
        _mha_tc_proj_bytes(MHA_TC_ROWS, dense_cols, D), key_tiles, warps,
        -(-T // (16 * warps)), _mha_tc_attn_bytes(hd, key_tiles, warps))


# the bf16 backward's kernels on the tensor cores (csrc/mha_block.cu
# mha_bwd_out_tc_kernel, attn_bwd_tc_kernel, mha_bwd_qkv_tc_kernel): the
# per-frame launches take tiles of MHA_TC_ROWS frames a row and slices of a
# weight's rows of a multiple of 16 (the most that fit); the attention a
# CTA of MHA_TC_ATTN_WARPS warps a (row, head) holding every key of the row
# in tiles of 16, built for these counts of them at each head dim (the most
# the keys of mha_route's T limit need: 223, 209, 183 and 143)
MHA_TC_BWD_KEY_TILES = {8: (1, 2, 4, 8, 14), 16: (1, 2, 4, 8, 14),
                        32: (1, 2, 4, 8, 12), 64: (1, 2, 4, 8, 9)}


def _mha_tc_bwd_frames_bytes(sn, K, D, a_smem=True):
    """csrc/mha_block.cu tc_bwd_frames_bytes: two fp32 tiles [rows][D] and
    the rows' inverse deviations, then (a_smem) the product's A tile [rows]
    and a slice of sn of a weight's rows, of K values at _tc_stride(K
    rounded up to 64), bf16."""
    kp = -(-K // 64) * 64
    return (4 * (2 * MHA_TC_ROWS * D + MHA_TC_ROWS)
            + 2 * ((MHA_TC_ROWS if a_smem else 0) + sn) * _tc_stride(kp))


def _mha_tc_attn_bwd_bytes(hd, key_tiles, share=False):
    """csrc/mha_block.cu tc_attn_bwd_bytes: k, v, qs, gh [16 key_tiles]
    rows of bf16 at _tc_stride(max(hd, 16)), P and dS (one buffer with
    share) [16 key_tiles][_tc_stride(16 key_tiles)] bf16, the key terms and
    the column sums' partials [3][key_tiles][hd] fp32."""
    rows = 16 * key_tiles
    return (2 * (4 * rows * _tc_stride(max(hd, 16))
                 + (1 if share else 2) * rows * _tc_stride(rows))
            + 4 * (rows + 3 * key_tiles * hd))


def _mha_tc_attn_bwd_share(hd, key_tiles):
    """csrc/mha_block.cu tc_attn_bwd_share: P and dS in one buffer (dS's
    scores computed again) where the two do not fit a block."""
    return _mha_tc_attn_bwd_bytes(hd, key_tiles) > MAX_SMEM_BYTES


class MHABwdBf16Plan(NamedTuple):
    """One call of the bf16 MHA block backward on the tensor cores: the two
    per-frame launches on `tiles` = ceil(T / rows) tiles a row, bf16(Wd)'s
    rows in slices of `out_slice` and bf16(Wqkv)'s of `qkv_slice`, their
    products' A tiles in shared memory where `a_smem` (else read from
    device memory), `smem_out` and `smem_qkv` bytes; the attention on `attn_ctas` = B *
    heads CTAs, a (row, head) each, its T keys in `key_tiles` tiles of 16,
    P and dS in one buffer where `share`, `smem_attention` bytes."""
    rows: int
    tiles: int
    out_slice: int
    qkv_slice: int
    a_smem: bool
    smem_out: int
    smem_qkv: int
    key_tiles: int
    share: bool
    attn_ctas: int
    smem_attention: int


@functools.lru_cache(maxsize=256)
def mha_bwd_bf16_plan(B, T, D, n_heads):
    """The bf16 MHA block backward's launch plan for B rows of [T, D] in
    n_heads heads of MHA_HEAD_DIMS: per-frame tiles of MHA_TC_ROWS frames a
    row with the widest slices of the weights' rows (multiples of 16, no
    wider than D rounded up to 16) that fit; the attention on the fewest of
    MHA_TC_BWD_KEY_TILES[hd] that hold T. At [16, 128, 128] in 8 heads:
    8 x 16 tiles of ~50 and ~116 KB, 128 attention CTAs of 8 key tiles;
    at the query stream's [16, 12, 128], 16 tiles and 128 CTAs of one key
    tile. Raises on what the kernels cannot take: D not a multiple of 8, T
    above the key tiles' keys, a slice of 16 rows that does not fit."""
    hd = _head_dim("mha_bwd_bf16_plan", D, n_heads)
    if B < 1 or T < 1 or D % 8:
        raise ValueError("mha_bwd_bf16_plan: needs B, T >= 1 and D %% 8 == 0,"
                         " got B=%d, T=%d, D=%d" % (B, T, D))
    key_tiles = next((k for k in MHA_TC_BWD_KEY_TILES[hd] if 16 * k >= T), None)
    if key_tiles is None:
        raise ValueError("mha_bwd_bf16_plan: T=%d above the %d keys the "
                         "attention holds at head dim %d"
                         % (T, 16 * MHA_TC_BWD_KEY_TILES[hd][-1], hd))
    dn = -(-D // 16) * 16

    def widest(K, a_smem):
        return next((sn for sn in range(dn, 15, -16)
                     if _mha_tc_bwd_frames_bytes(sn, K, D, a_smem)
                     <= MAX_SMEM_BYTES), None)

    # the A tiles in shared memory where both launches fit them beside a
    # slice (D up to about 700), else read from device memory
    a_smem = None not in (widest(D, True), widest(3 * D, True))
    out_slice, qkv_slice = widest(D, a_smem), widest(3 * D, a_smem)
    if out_slice is None or qkv_slice is None:
        raise ValueError("mha_bwd_bf16_plan: D=%d needs %d bytes of shared "
                         "memory a tile, above the %d a block has"
                         % (D, _mha_tc_bwd_frames_bytes(16, 3 * D, D, False),
                            MAX_SMEM_BYTES))
    share = _mha_tc_attn_bwd_share(hd, key_tiles)
    return MHABwdBf16Plan(
        MHA_TC_ROWS, -(-T // MHA_TC_ROWS), out_slice, qkv_slice, a_smem,
        _mha_tc_bwd_frames_bytes(out_slice, D, D, a_smem),
        _mha_tc_bwd_frames_bytes(qkv_slice, 3 * D, D, a_smem), key_tiles,
        share, B * n_heads, _mha_tc_attn_bwd_bytes(hd, key_tiles, share))


# --- 3c. the bf16 MHA block at head dim 128 --------------------------------------
# #3b and #10b at the JAX bench's `saturated` widths (D = 1024 in 8 heads of
# 128; csrc/mha_block.cu, the wide kernels): the per-frame launches split
# at their products, which run [B T, D] x [D, 3D] and [B T, D] x [D, D] (and
# their transposes) over every frame at once on the tensor cores (mma.cuh
# tc_gemm); each attention is a tensor-core kernel of its own, a CTA a
# (row, head) with the head's k, v, q (and g_att) as bf16 rows
# (attn_fwd_wide_kernel, attn_bwd_wide_kernel); qkv is kept in bf16.
# bf16 only: at fp32 head dim 128 stays on the plain version.
MHA_WIDE_HEAD_DIMS = (128,)


def _wide_head_dim(D, n_heads):
    return (n_heads >= 1 and D % n_heads == 0 and D % TC_GEMM_N == 0
            and D // n_heads in MHA_WIDE_HEAD_DIMS)


# the wide attentions: warps a CTA (csrc/mha_block.cu kAttnWideWarps),
# each taking 16 queries, so T <= 16 * 8 at head dim 128; the forward fits
# two CTAs an SM (its __launch_bounds__), the backward one
MHA_WIDE_ATTN_WARPS = 8
MHA_WIDE_ATTN_TILES = (1, 2, 4, 8)  # the kernels' instances, tiles of 16 keys
MHA_WIDE_ATTN_FWD_CTAS_PER_SM = 2


def _mha_wide_attn_fwd_bytes(tiles, hd=128):
    """csrc/mha_block.cu attn_wide_fwd_bytes for `tiles` tiles of 16 keys."""
    rows = 16 * tiles
    return 2 * (3 * rows * _tc_stride(hd)) + 4 * rows


def _mha_wide_attn_bwd_bytes(tiles, hd=128):
    """csrc/mha_block.cu attn_wide_bwd_bytes for `tiles` tiles of 16 keys."""
    rows = 16 * tiles
    return (2 * (4 * rows * _tc_stride(hd) + 2 * rows * _tc_stride(rows))
            + 4 * (rows + 3 * tiles * hd))


# frames a batch of the backward's LayerNorm passes (csrc/mha_block.cu
# wide_ln_pass_kernel, kWideLnFrames), streamed as the conv backward's
WIDE_LN_FRAMES = 2


def _mha_wide_ln_bytes(D):
    """csrc/mha_block.cu wide_ln_pass_bytes."""
    return 4 * (4 * 3 * WIDE_LN_FRAMES * D + 2 * (D // 128) * 3 * WIDE_LN_FRAMES)


class MHAWidePlan(NamedTuple):
    """One call of the wide block kernels: the backward's LayerNorm passes
    on `ctas` = B * `strips` CTAs of D / 4 threads streaming `strip`
    frames of a row, `smem_frames` bytes each; both attentions on
    `attn_ctas` = B * heads CTAs of MHA_WIDE_ATTN_WARPS warps, a (row,
    head) each, its T keys in `attn_tiles` tiles of 16 (`smem_attn_fwd`
    and `smem_attn_bwd` bytes)."""
    strip: int
    strips: int
    ctas: int
    smem_frames: int
    attn_tiles: int
    attn_ctas: int
    smem_attn_fwd: int
    smem_attn_bwd: int


@functools.lru_cache(maxsize=256)
def mha_wide_plan(B, T, D, n_heads):
    """The wide block kernels' plan for B rows of [T, D] in n_heads heads of
    MHA_WIDE_HEAD_DIMS: both attentions on the fewest of
    MHA_WIDE_ATTN_TILES tiles of 16 keys that hold T; strips as
    conv_wide_plan's. Raises on what the kernels cannot take (T above 16 *
    MHA_WIDE_ATTN_WARPS = 128 at head dim 128, D above 1024)."""
    if not _wide_head_dim(D, n_heads):
        raise ValueError("mha_wide_plan: head dim D/n_heads must be one of %s "
                         "with D a multiple of %d, got D=%d heads=%d"
                         % (MHA_WIDE_HEAD_DIMS, TC_GEMM_N, D, n_heads))
    if B < 1 or T < 1:
        raise ValueError("mha_wide_plan: needs B, T >= 1, got B=%d, T=%d"
                         % (B, T))
    if D > 4 * 256:
        raise ValueError("mha_wide_plan: D=%d above the 1024 columns the "
                         "LayerNorm passes take (4 a thread of 256)" % D)
    if T > 16 * MHA_WIDE_ATTN_WARPS:
        raise ValueError("mha_wide_plan: T=%d above the %d keys the "
                         "attentions at head dim 128 hold (a warp a 16 "
                         "queries)" % (T, 16 * MHA_WIDE_ATTN_WARPS))
    hd = D // n_heads
    tiles = next(n for n in MHA_WIDE_ATTN_TILES if 16 * n >= T)
    strip = _wide_strip(B, T)
    strips = -(-T // strip)
    return MHAWidePlan(strip, strips, B * strips, _mha_wide_ln_bytes(D),
                       tiles, B * n_heads, _mha_wide_attn_fwd_bytes(tiles, hd),
                       _mha_wide_attn_bwd_bytes(tiles, hd))


def _launch_mha_block_fwd_wide(x, mask, gam, beta, wqkv, bqkv, wd, bd,
                               n_heads, seeds, drop_rate):
    """launch_mha_block_fwd at head dim 128: the wide kernels on
    mha_wide_plan, (out, qkv, att) as the bf16 block forward gives them
    but qkv in bf16 (its values are bf16 either way)."""
    name = "mha_block_fwd_wide_bf16"
    _require_bf16(name, x)
    _require_cuda(name, x, mask, gam, beta, wqkv, bqkv, wd, bd)
    B, T, D = _mha_shapes(name, x, n_heads, 0, mask, gam, beta, wqkv, wd,
                          bqkv, bd, x.dtype)
    plan = mha_wide_plan(B, T, D, n_heads)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    # the products read bf16(Wqkv) and bf16(Wd), the function's roundings
    wqkvb, wdb = (w.to(torch.bfloat16).contiguous() for w in (wqkv, wd))
    qkv = torch.empty(B, T, 3 * D, device=x.device, dtype=torch.bfloat16)
    att = _empty(x.device, B, T, D)
    out = torch.empty_like(x)
    y_ws = torch.empty_like(x)
    _launch(name, x.data_ptr(), mask.data_ptr(), gam.data_ptr(),
            beta.data_ptr(), wqkvb.data_ptr(), bqkv.data_ptr(), wdb.data_ptr(),
            bd.data_ptr(), sp, thresh, scale, qkv.data_ptr(), att.data_ptr(),
            out.data_ptr(), y_ws.data_ptr(), B, T, D, n_heads,
            plan.attn_tiles)
    return out, qkv, att


def _launch_mha_block_bwd_wide(x, mask, gam, beta, wqkv, wd, n_heads, seeds,
                               drop_rate, qkv, att, g):
    """launch_mha_block_bwd at head dim 128: the wide kernels on
    mha_wide_plan, the bf16 block backward's gradients."""
    name = "mha_block_bwd_wide_bf16"
    _require_bf16(name, x)
    _require_cuda(name, x, mask, gam, beta, wqkv, wd, qkv, att, g)
    B, T, D = _mha_shapes(name, x, n_heads, 0, mask, gam, beta, wqkv, wd,
                          dtype=x.dtype)
    _check(name, qkv, (B, T, 3 * D), torch.bfloat16)
    _check(name, att, (B, T, D))
    _check(name, g, (B, T, D), x.dtype)
    plan = mha_wide_plan(B, T, D, n_heads)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    dev = x.device
    wqkvb, wdb = (w.to(torch.bfloat16).contiguous() for w in (wqkv, wd))
    dx = torch.empty_like(x)
    dsmall = _empty(dev, 8 * D)
    dwqkv = _empty(dev, D, 3 * D)
    dwd = _empty(dev, D, D)
    gdt, z, y = (torch.empty_like(x) for _ in range(3))
    gz, gres, gatt = (_empty(dev, B, T, D) for _ in range(3))
    dqkvt = torch.empty(B, T, 3 * D, device=dev, dtype=torch.bfloat16)
    part = _empty(dev, plan.ctas, 8 * D)
    # dwqkv's and dwd's splits, one workspace for either
    splits = wgrad_splits(1, D, 3 * D, B * T)
    splits_d = wgrad_splits(1, D, D, B * T)
    ws = _empty(dev, max(splits * 3 if splits > 1 else 0,
                         splits_d if splits_d > 1 else 0, 1) * D * D)
    _launch(name, x.data_ptr(), mask.data_ptr(), gam.data_ptr(),
            beta.data_ptr(), wqkvb.data_ptr(), wdb.data_ptr(), sp, thresh,
            scale, qkv.data_ptr(), att.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dsmall.data_ptr(), dwqkv.data_ptr(), dwd.data_ptr(),
            gdt.data_ptr(), gz.data_ptr(), z.data_ptr(), gres.data_ptr(),
            gatt.data_ptr(), dqkvt.data_ptr(), y.data_ptr(), part.data_ptr(),
            ws.data_ptr(), splits, splits_d, B, T, D, n_heads, plan.strip,
            plan.attn_tiles)
    return (dx, dsmall[:2 * D].view(2, D), dsmall[2 * D:4 * D].view(2, D),
            dwqkv, dsmall[4 * D:7 * D], dwd, dsmall[7 * D:])


def _mha_shapes(name, x, n_heads, smem, mask, gam, beta, wqkv, wd, bqkv=None,
                bd=None, dtype=torch.float32):
    B, T, D = x.shape
    if not _wide_head_dim(D, n_heads):
        _head_dim(name, D, n_heads)
    if smem > MAX_SMEM_BYTES:
        raise ValueError("%s: T=%d, D=%d needs %d bytes of shared memory, "
                         "above the %d a block has" % (name, T, D, smem,
                                                       MAX_SMEM_BYTES))
    _check(name, x, (B, T, D), dtype)
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
                         seeds=None, drop_rate=0.0, wqkvb=None, wdb=None):
    """The forward kernels on mha_fwd_plan's tiles: (out, qkv [B, T, 3D],
    att [B, T, D]), the last two being what the backward reads back; for
    bf16 x the bf16 entry point, the tensor-core kernels on
    mha_fwd_bf16_plan (out in x's dtype, qkv stored in bf16, att float32;
    wqkvb, wdb: bf16(Wqkv), bf16(Wd) where the caller has them, else made
    here), the wide kernels at head dim 128 (qkv stored in bf16). CUDA
    tensors only."""
    if _wide_head_dim(x.shape[-1], n_heads):
        return _launch_mha_block_fwd_wide(x, mask, gam, beta, wqkv, bqkv, wd,
                                          bd, n_heads, seeds, drop_rate)
    bf16 = _act_dtype("mha_block_fwd", x) == torch.bfloat16
    name = _entry("mha_block_fwd", x.dtype)
    _require_cuda(name, x, mask, gam, beta, wqkv, bqkv, wd, bd)
    B, T, D = _mha_shapes(name, x, n_heads, 0, mask, gam, beta, wqkv, wd,
                          bqkv, bd, x.dtype)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    att = _empty(x.device, B, T, D)
    out = torch.empty_like(x)
    if bf16:
        plan = mha_fwd_bf16_plan(B, T, D, n_heads)
        # the products read bf16(Wqkv) and bf16(Wd), the function's
        # roundings, made once a call, by 16-byte cp.async
        wqkvb, wdb = _bf16_of(name, wqkv, wqkvb), _bf16_of(name, wd, wdb)
        qkv = torch.empty(B, T, 3 * D, device=x.device, dtype=torch.bfloat16)
        _launch(name, x.data_ptr(), mask.data_ptr(), gam.data_ptr(),
                beta.data_ptr(), wqkvb.data_ptr(), bqkv.data_ptr(),
                wdb.data_ptr(), bd.data_ptr(), sp, thresh, scale,
                qkv.data_ptr(), att.data_ptr(), out.data_ptr(), B, T, D,
                n_heads, plan.rows, plan.qkv_cols, plan.dense_cols)
        return out, qkv, att
    plan = mha_fwd_plan(B, T, D, n_heads)
    # the per-frame launches copy the weights by 16-byte cp.async
    wqkv, wd = _aligned16(wqkv, wd)
    qkv = _empty(x.device, B, T, 3 * D)
    _launch(name, x.data_ptr(), mask.data_ptr(), gam.data_ptr(),
            beta.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wd.data_ptr(),
            bd.data_ptr(), sp, thresh, scale, qkv.data_ptr(), att.data_ptr(),
            out.data_ptr(), B, T, D, n_heads, plan.frames, plan.slice_rows,
            plan.q_tile)
    return out, qkv, att


def launch_mha_block_bwd(x, mask, gam, beta, wqkv, wd, n_heads, seeds,
                         drop_rate, qkv, att, g, wqkvb=None, wdb=None):
    """The backward kernels on mha_bwd_plan's tiles: (dx, dgam, dbeta,
    dwqkv, dbqkv, dwd, dbd), the weight gradients summed over the batch;
    the bf16 entry point for bf16 x, the tensor-core kernels on
    mha_bwd_bf16_plan (g, dx and the forward's qkv in x's dtype; att and
    the weight gradients float32 either way; wqkvb, wdb: the forward's
    bf16(Wqkv), bf16(Wd) where the caller has them, else made here; at head
    dim 128 the wide kernels). CUDA tensors only."""
    if _wide_head_dim(x.shape[-1], n_heads):
        return _launch_mha_block_bwd_wide(x, mask, gam, beta, wqkv, wd,
                                          n_heads, seeds, drop_rate, qkv, att,
                                          g)
    if _act_dtype("mha_block_bwd", x) == torch.bfloat16:
        return _launch_mha_block_bwd_bf16(x, mask, gam, beta, wqkv, wd,
                                          n_heads, seeds, drop_rate, qkv, att,
                                          g, wqkvb, wdb)
    name = "mha_block_bwd"
    _require_cuda(name, x, mask, gam, beta, wqkv, wd, qkv, att, g)
    B, T, D = _mha_shapes(name, x, n_heads, 0, mask, gam, beta, wqkv, wd,
                          dtype=x.dtype)
    _check(name, qkv, (B, T, 3 * D), x.dtype)
    _check(name, att, (B, T, D))
    _check(name, g, (B, T, D), x.dtype)
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


def _launch_mha_block_bwd_bf16(x, mask, gam, beta, wqkv, wd, n_heads, seeds,
                               drop_rate, qkv, att, g, wqkvb=None, wdb=None):
    """launch_mha_block_bwd for bf16 x below head dim 128: the tensor-core
    kernels (csrc/mha_block.cu mha_bwd_out_tc_kernel, attn_bwd_tc_kernel,
    mha_bwd_qkv_tc_kernel) on mha_bwd_bf16_plan."""
    name = "mha_block_bwd_bf16"
    _require_cuda(name, x, mask, gam, beta, wqkv, wd, qkv, att, g)
    B, T, D = _mha_shapes(name, x, n_heads, 0, mask, gam, beta, wqkv, wd,
                          dtype=x.dtype)
    _check(name, qkv, (B, T, 3 * D), torch.bfloat16)
    _check(name, att, (B, T, D))
    _check(name, g, (B, T, D), x.dtype)
    plan = mha_bwd_bf16_plan(B, T, D, n_heads)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    dev = x.device
    # the products read bf16(Wqkv)'s and bf16(Wd)'s rows, the forward's
    # roundings, by 16-byte cp.async
    wqkvb, wdb = _bf16_of(name, wqkv, wqkvb), _bf16_of(name, wd, wdb)
    dx = torch.empty_like(x)
    dsmall = _empty(dev, 8 * D)
    dwqkv = _empty(dev, D, 3 * D)
    dwd = _empty(dev, D, D)
    # the bf16 workspaces z, g_dpre, g_att, y [B, T, D] and bf16(dqkv) [B, T,
    # 3D]; g_res, the tiles' partials and the split-K partials fp32
    splits = _wgrad_splits(1, D, 3 * D, B * T)
    btd = B * T * D
    work16 = torch.empty(7 * btd, device=dev, dtype=torch.bfloat16)
    z, gdpre, gatt, y = (work16[i * btd:] for i in range(4))
    dqkvt = work16[4 * btd:]
    n_part = B * plan.tiles * 8 * D
    work = _empty(dev, btd + n_part + (splits * D * 3 * D if splits > 1
                                       else 1))
    gres, part, ws = work, work[btd:], work[btd + n_part:]
    _launch(name, x.data_ptr(), mask.data_ptr(), gam.data_ptr(),
            beta.data_ptr(), wqkvb.data_ptr(), wdb.data_ptr(), sp, thresh,
            scale, qkv.data_ptr(), att.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dsmall.data_ptr(), dwqkv.data_ptr(), dwd.data_ptr(), z.data_ptr(),
            gdpre.data_ptr(), gres.data_ptr(), gatt.data_ptr(), y.data_ptr(),
            dqkvt.data_ptr(), part.data_ptr(), ws.data_ptr(), splits, B, T, D,
            n_heads, plan.out_slice, plan.qkv_slice, plan.key_tiles,
            int(plan.a_smem))
    return (dx, dsmall[:2 * D].view(2, D), dsmall[2 * D:4 * D].view(2, D),
            dwqkv, dsmall[4 * D:7 * D], dwd, dsmall[7 * D:])


class FusedMHABlock(torch.autograd.Function):
    """The MHA block on the card: forward kernels, backward kernels; qkv
    and the attention output are kept from the forward, and at bf16 below
    head dim 128 one rounding of Wqkv and Wd a step, read by both."""

    @staticmethod
    def forward(ctx, x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads, seeds,
                drop_rate):
        wb = ([w.to(torch.bfloat16).contiguous() for w in (wqkv, wd)]
              if x.dtype == torch.bfloat16
              and not _wide_head_dim(x.shape[-1], n_heads) else [])
        out, qkv, att = launch_mha_block_fwd(x, mask, gam, beta, wqkv, bqkv,
                                             wd, bd, n_heads, seeds, drop_rate,
                                             *wb)
        ctx.save_for_backward(x, mask, gam, beta, wqkv, wd, seeds, qkv, att,
                              *wb)
        ctx.n_heads, ctx.drop_rate = n_heads, drop_rate
        return out

    @staticmethod
    def backward(ctx, g):
        x, mask, gam, beta, wqkv, wd, seeds, qkv, att, *wb = ctx.saved_tensors
        dx, dgam, dbeta, dwqkv, dbqkv, dwd, dbd = launch_mha_block_bwd(
            x, mask, gam, beta, wqkv, wd, ctx.n_heads, seeds, ctx.drop_rate,
            qkv, att, g.contiguous(), *wb)
        return (dx, None, dgam, dbeta, dwqkv, dbqkv, dwd, dbd, None, None,
                None)


def mha_block_twin(x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads,
                   seeds=None, drop_rate=0.0, vjp=None):
    """fused_mha_block's plain version at x's dtype, what the CPU runs: at
    bf16 beyond the block route mha_block_unfused, whose fused_mha runs
    the twins of the route's bf16 kernels (the function the card computes
    there, not the block kernel's); else mha_block_plain, through
    PlainMHABlock (the backward twin) where vjp, by default where bf16 x
    or a weight wants a gradient."""
    args = (x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads, seeds)
    bf16 = x.dtype == torch.bfloat16
    if bf16 and mha_route(x.shape[1], x.shape[2], n_heads, x.dtype) != "block":
        return mha_block_unfused(*args, float(drop_rate))
    if vjp is None:
        vjp = bf16 and grad_wanted(x, gam, beta, wqkv, bqkv, wd, bd)
    if vjp:
        return PlainMHABlock.apply(*args, float(drop_rate))
    return mha_block_plain(*args, drop_rate)


def fused_mha_block(x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads,
                    seeds=None, drop_rate=0.0):
    """On the card: the block kernels where mha_route says "block", else
    mha_block_unfused (fused_mha's whole-T or flash kernels), at x's dtype:
    bf16 x takes the bf16 block kernels, or beyond them the unfused block
    at bf16 around the bf16 whole-T or flash kernels. On the CPU:
    mha_block_twin."""
    name = "mha_block_fwd"
    tensors = [x, mask, gam, beta, wqkv, bqkv, wd, bd]
    if seeds is not None:
        tensors.append(seeds)
    args = (x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads, seeds)
    _act_dtype(name, x)
    if not _on_cuda(name, *tensors):
        return mha_block_twin(*args, drop_rate)
    if mha_route(x.shape[1], x.shape[2], n_heads, x.dtype) == "block":
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
# register-tiled out of shared memory. At bf16 (q, k, v bf16) each kernel
# computes the TPU kernel's function at bf16 (#11b-#14b); the bf16 flash
# kernels are kernels of their own, on the tensor cores
# (flash_fwd_bf16_plan, flash_bwd_bf16_plan). The plain twins below write
# those functions out, and their backwards the custom VJPs.

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


# keys a tile of the TPU flash kernels' online softmax (pallas_kernels.py
# _FLASH_TK): at bf16 the flash forward rounds exp(s - m) against the
# running max of such windows
FLASH_WINDOW = 1024

# The bf16 flash kernels (#13b, #14b) run their products on the tensor
# cores (csrc/mma.cuh): a warp keeps 16 rows of one operand as mma
# fragments. The forward: 16 queries a warp, FLASH_FWD_BF16_WARPS warps a
# CTA, key tiles of FLASH_FWD_BF16_KEYS streamed through two buffers
# (csrc/flash_mha.cu kTcFwdWarps, kTcKeys); the backward: 16 keys a warp,
# FLASH_BWD_BF16_WARPS warps a CTA (its key tile), query tiles of
# FLASH_BWD_BF16_QTILE streamed (kTcBwdWarps, kTcQ).
FLASH_FWD_BF16_WARPS = 8
FLASH_FWD_BF16_KEYS = 128
FLASH_BWD_BF16_WARPS = 8
FLASH_BWD_BF16_QTILE = 64


def _tc_stride(n):
    """The row stride, in bf16 values, of a shared tile of rows of n values
    (csrc/mma.cuh tc_stride): an odd number of 16-byte chunks."""
    return n if (n // 8) % 2 else n + 8


class FlashFwdBf16Plan(NamedTuple):
    """One call of the bf16 flash forward: `ctas` = q_tiles * n_heads * B
    CTAs of `warps` warps, 16 queries a warp (`q_tile` a CTA); each streams
    the head's `key_tiles` key tiles of `key_tile` keys twice a window of
    `window` keys (the row max, then P.V) through two buffers of
    `smem_bytes` together."""
    warps: int
    q_tile: int
    q_tiles: int
    key_tile: int
    key_tiles: int
    window: int
    smem_bytes: int
    ctas: int


def flash_fwd_bf16_plan(B, T, D, n_heads):
    """The bf16 flash forward's launch plan for B rows of [T, D] and
    n_heads heads (csrc/flash_mha.cu flash_fwd_bf16_kernel). Path L's [8,
    1024, 128] in 8 heads of 16: 512 CTAs of 8 warps and 128 queries, 8
    key tiles of 128 each, 25 KB. Raises on what the kernel cannot
    take."""
    hd = _head_dim("flash_fwd_bf16_plan", D, n_heads)
    if B < 1 or T < 1:
        raise ValueError("flash_fwd_bf16_plan: needs B, T >= 1, got B=%d, "
                         "T=%d" % (B, T))
    warps = FLASH_FWD_BF16_WARPS
    q_tile = 16 * warps
    q_tiles = -(-T // q_tile)
    keys = FLASH_FWD_BF16_KEYS
    smem = 2 * (2 * keys * _tc_stride(hd) * 2 + keys * 4)
    return FlashFwdBf16Plan(warps, q_tile, q_tiles, keys, -(-T // keys),
                            FLASH_WINDOW, smem, q_tiles * n_heads * B)


class FlashBwdBf16Plan(NamedTuple):
    """One call of the bf16 flash backward: `key_tiles` CTAs a (row,
    head) of `warps` warps, 16 keys a warp (`key_tile` a CTA), each
    streaming `q_tiles` query tiles of `q_tile`, `smem_bytes` each, `ctas`
    in all; the key tiles' dQ partials in a workspace of
    `workspace_bytes`, summed in key-tile order."""
    warps: int
    key_tile: int
    key_tiles: int
    q_tile: int
    q_tiles: int
    smem_bytes: int
    ctas: int
    workspace_bytes: int


def flash_bwd_bf16_plan(B, T, D, n_heads):
    """The bf16 flash backward's launch plan for B rows of [T, D] and
    n_heads heads (csrc/flash_mha.cu flash_bwd_bf16_kernel): the key tile's
    K, two buffers of a query tile's qs and G (bf16), lse and delta, and
    its dS^T (bf16). Path L's [8, 1024, 128] in 8 heads of 16: 512 CTAs of
    8 warps and 128 keys, 16 query tiles of 64 each, 37 KB, a dQ workspace
    of 8 partials (32 MiB). Raises on what the kernels cannot take."""
    hd = _head_dim("flash_bwd_bf16_plan", D, n_heads)
    if B < 1 or T < 1:
        raise ValueError("flash_bwd_bf16_plan: needs B, T >= 1, got B=%d, "
                         "T=%d" % (B, T))
    warps = FLASH_BWD_BF16_WARPS
    key_tile, q_tile = 16 * warps, FLASH_BWD_BF16_QTILE
    key_tiles = -(-T // key_tile)
    smem = (2 * (key_tile * _tc_stride(hd) + 4 * q_tile * _tc_stride(hd))
            + 16 * q_tile + 2 * key_tile * _tc_stride(q_tile))
    return FlashBwdBf16Plan(warps, key_tile, key_tiles, q_tile,
                            -(-T // q_tile), smem, key_tiles * n_heads * B,
                            4 * key_tiles * B * T * D)


def _heads(t, n_heads):
    """[B, T, D] -> [B, H, T, D / H] in float32."""
    B, T, D = t.shape
    return t.to(torch.float32).reshape(B, T, n_heads, D // n_heads).transpose(
        1, 2)


def _merge_heads(t, dtype):
    B, H, T, hd = t.shape
    return t.transpose(1, 2).reshape(B, T, H * hd).to(dtype)


def _head_scale(hd, dtype):
    """1 / sqrt(hd) rounded to dtype (the TPU kernels' `dtype(scale)`), as
    a Python float."""
    return float(torch.tensor(1.0 / math.sqrt(float(hd)),
                              dtype=torch.float64).to(dtype))


def _keep_bits(seeds, drop_rate, n_heads, T):
    """[B, H, T, T] bool: the heads' keep masks, or None at drop 0."""
    if not drop_rate > 0.0:
        return None
    if seeds is None:
        raise ValueError("drop_rate > 0 needs per-row seeds [B, 1]")
    bits = torch.stack([mha_hash_bits(seeds, h, T) for h in range(n_heads)],
                       dim=1)
    return bits >= drop_threshold(drop_rate)


def _drop_keep(a, keep, drop_rate):
    return a if keep is None else torch.where(
        keep, a * (1.0 / (1.0 - drop_rate)), 0.0)


def flash_attention_plain(q, k, v, mask, n_heads, seeds=None, drop_rate=0.0):
    """(out, lse [B, H, T]) in q's dtype and float32. At float32,
    attention's output and the logsumexp over the keys of each head's
    masked, scaled scores (what the flash forward saves). For bf16 q, k, v,
    the flash forward kernel's function at bf16 (#13b,
    pallas_kernels.py:1395-1451), which is not attention's: qs =
    bf16(q_h * bf16 scale), fp32 scores; for each key window of
    FLASH_WINDOW keys in turn, m <- max(m, the window's row max), p =
    exp(s - m) unnormalised, l <- l alpha + sum p (fp32, unrounded), acc
    <- acc alpha + bf16(drop(p)) . v_h (fp32 sums); out = bf16(acc / l),
    lse = m + log l."""
    if q.dtype != torch.bfloat16:
        out, s = _attention_scores(q, k, v, mask, n_heads, seeds, drop_rate)
        return out, torch.logsumexp(s, dim=-1)
    act, f32 = q.dtype, torch.float32
    B, T, D = q.shape
    scale = _head_scale(D // n_heads, act)
    qs = (_heads(q, n_heads) * scale).to(act).to(f32)
    s = qs @ _heads(k, n_heads).transpose(-1, -2) + (
        (1.0 - mask.to(f32)) * -1e30).reshape(B, 1, 1, T)
    vh = _heads(v, n_heads)
    keep = _keep_bits(seeds, drop_rate, n_heads, T)
    m = torch.full((B, n_heads, T, 1), -math.inf, dtype=f32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qs)
    for j0 in range(0, T, FLASH_WINDOW):
        win = slice(j0, j0 + FLASH_WINDOW)
        sw = s[..., win]
        m_new = torch.maximum(m, sw.amax(dim=-1, keepdim=True))
        p = torch.exp(sw - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        p = _drop_keep(p, None if keep is None else keep[..., win], drop_rate)
        acc = acc * alpha + p.to(act).to(f32) @ vh[:, :, win]
        m = m_new
    return _merge_heads(acc / l, act), (m + torch.log(l))[..., 0]


def attention_bwd_plain(q, k, v, mask, n_heads, seeds, drop_rate, g):
    """The whole-T backward, written out as `_make_mha_bwd_kernel` computes
    it (pallas_kernels.py:716-756) at q's dtype: per head, qs = q_h * scale
    (both in q's dtype, rounded there), p recomputed (fp32 scores and
    softmax), dv = bf16(drop(p))^T . g_h, dp = drop(g_h . v_h^T), ds = p
    (dp - sum_j dp p), dq = (bf16(ds) . k_h) * scale, dk = bf16(ds)^T . qs,
    the products' sums fp32, then dq, dk and dv rounded to q's dtype (bf16
    roundings at bf16, none at float32: there the fp32 kernel's function).
    -> (dq, dk, dv) [B, T, D]."""
    act, f32 = q.dtype, torch.float32

    def rnd(t):  # a rounding point at q's dtype, held in float32
        return t.to(act).to(f32)

    B, T, D = q.shape
    scale = _head_scale(D // n_heads, act)
    qs = rnd(_heads(q, n_heads) * scale)
    kh, vh, gh = (_heads(t, n_heads) for t in (k, v, g))
    p = torch.softmax(qs @ kh.transpose(-1, -2) + (
        (1.0 - mask.to(f32)) * -1e30).reshape(B, 1, 1, T), dim=-1)
    keep = _keep_bits(seeds, drop_rate, n_heads, T)
    dv = rnd(_drop_keep(p, keep, drop_rate)).transpose(-1, -2) @ gh
    dp = _drop_keep(gh @ vh.transpose(-1, -2), keep, drop_rate)
    ds = rnd(p * (dp - (dp * p).sum(dim=-1, keepdim=True)))
    return (_merge_heads((ds @ kh) * scale, act),
            _merge_heads(ds.transpose(-1, -2) @ qs, act),
            _merge_heads(dv, act))


def flash_attention_bwd_plain(q, k, v, mask, n_heads, seeds, drop_rate, out,
                              lse, g, scale_dtype=torch.float32):
    """The flash backward, written out as `_make_flash_bwd_kernel` and
    `_fused_mha_bwd` compute it (pallas_kernels.py:1454-1529, 894-898) at
    q's dtype, from the forward's out and lse [B, H, T]: per head, qs =
    q_h * scale rounded to q's dtype with the scale FLOAT32 (:1460; at head
    dims 8 and 32 not the forward's bf16 scale, ROADMAP.md C6; scale_dtype
    bf16 takes the forward's, which the checks use as a control), delta = sum
    g_h out_h (fp32), p = exp(qs . k_h^T + mask - lse), or 1 / T on a row
    with no valid key (as the port's kernels take it; the TPU kernel's p is
    1 there, ROADMAP.md C3), dv = bf16(drop(p))^T . g_h, ds = bf16(p
    (drop(g_h . v_h^T) - delta)), dq = (ds . k_h) * scale, dk = ds^T . qs,
    the sums fp32 over every query, then dq, dk and dv rounded to q's dtype
    once. -> (dq, dk, dv) [B, T, D]."""
    act, f32 = q.dtype, torch.float32

    def rnd(t):  # a rounding point at q's dtype, held in float32
        return t.to(act).to(f32)

    B, T, D = q.shape
    scale = _head_scale(D // n_heads, scale_dtype)
    qs = rnd(_heads(q, n_heads) * scale)
    kh, vh, gh = (_heads(t, n_heads) for t in (k, v, g))
    delta = (gh * _heads(out, n_heads)).sum(dim=-1, keepdim=True)
    p = torch.exp(qs @ kh.transpose(-1, -2) + (
        (1.0 - mask.to(f32)) * -1e30).reshape(B, 1, 1, T) - lse[..., None])
    has_key = (mask.to(f32) != 0).any(dim=-1).reshape(B, 1, 1, 1)
    p = torch.where(has_key, p, 1.0 / T)
    keep = _keep_bits(seeds, drop_rate, n_heads, T)
    dv = rnd(_drop_keep(p, keep, drop_rate)).transpose(-1, -2) @ gh
    dp = _drop_keep(gh @ vh.transpose(-1, -2), keep, drop_rate)
    ds = rnd(p * (dp - delta))
    return (_merge_heads((ds @ kh) * scale, act),
            _merge_heads(ds.transpose(-1, -2) @ qs, act),
            _merge_heads(dv, act))


def whole_attention_plain(q, k, v, mask, n_heads, seeds=None, drop_rate=0.0):
    """The whole-T forward kernel's function at q's dtype (#11 at float32:
    `attention`; #11b at bf16, pallas_kernels.py:696-713: `attention`'s
    bf16 casts with float32 sums, the output rounded to bf16 once)."""
    f32 = torch.float32
    return _attention_scores(q.to(f32), k.to(f32), v.to(f32), mask, n_heads,
                             seeds, drop_rate, q.dtype)[0].to(q.dtype)


class PlainMHA(torch.autograd.Function):
    """FusedMHA's plain twin: whole_attention_plain, then
    attention_bwd_plain, the JAX package's VJP written out (at bf16 not
    torch's autograd of the forward twin, which rounds elsewhere). What the
    CPU runs for a bf16 gradient on the whole-T route."""

    @staticmethod
    def forward(ctx, q, k, v, mask, n_heads, seeds, drop_rate):
        ctx.save_for_backward(q, k, v, mask, seeds)
        ctx.n_heads, ctx.drop_rate = n_heads, drop_rate
        return whole_attention_plain(q, k, v, mask, n_heads, seeds, drop_rate)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, seeds = ctx.saved_tensors
        return (*attention_bwd_plain(q, k, v, mask, ctx.n_heads, seeds,
                                     ctx.drop_rate, g), None, None, None, None)


class PlainFlashMHA(torch.autograd.Function):
    """FusedFlashMHA's plain twin: flash_attention_plain, which keeps lse,
    then flash_attention_bwd_plain. What the CPU runs for a bf16 gradient
    on the flash route."""

    @staticmethod
    def forward(ctx, q, k, v, mask, n_heads, seeds, drop_rate):
        out, lse = flash_attention_plain(q, k, v, mask, n_heads, seeds,
                                         drop_rate)
        ctx.save_for_backward(q, k, v, mask, seeds, out, lse)
        ctx.n_heads, ctx.drop_rate = n_heads, drop_rate
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, seeds, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd_plain(q, k, v, mask, ctx.n_heads, seeds,
                                           ctx.drop_rate, out, lse, g),
                None, None, None, None)


def _attention_shapes(name, q, k, v, mask, n_heads, *more):
    """(B, T, D): q, k, v and `more` [B, T, D] in q's dtype (float32 or
    bfloat16), the mask [B, T] float32, a head dim a kernel takes."""
    dtype = _act_dtype(name, q)
    B, T, D = q.shape
    _head_dim(name, D, n_heads)
    for t in (q, k, v, *more):
        _check(name, t, (B, T, D), dtype)
    _check(name, mask, (B, T))
    return B, T, D


# query rows a CTA of the whole-T forward (the MHA block forward's
# attention body): the fastest at path M's [16, 192, 128] in
# vslnet_torch/bench/mha_plans.py --forward (PERF.md)
MHA_WHOLE_QTILE = 32


def launch_mha_fwd(q, k, v, mask, n_heads, seeds=None, drop_rate=0.0):
    """The whole-T forward kernel: out [B, T, D] in q's dtype, the bf16
    entry point (#11b) for bf16 q, k, v. CUDA tensors only."""
    name = _entry("mha_fwd", _act_dtype("mha_fwd", q))
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
    = g . out from the forward's output; at bf16 the bf16 entry point,
    #12b, which sums D_t over the keys and does not read out): (dq, dk,
    dv) in q's dtype. CUDA tensors only."""
    name = _entry("mha_bwd", _act_dtype("mha_bwd", q))
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
    """The flash forward kernel on flash_fwd_plan: (out [B, T, D] in q's
    dtype, lse [B, H, T] float32); for bf16 q, k, v the bf16 entry point
    (#13b, tensor cores) on flash_fwd_bf16_plan. CUDA tensors only."""
    name = _entry("flash_mha_fwd", _act_dtype("flash_mha_fwd", q))
    _require_cuda(name, q, k, v, mask)
    B, T, D = _attention_shapes(name, q, k, v, mask, n_heads)
    # the fp32 kernel takes its plan's query rows a thread
    rows = ([] if q.dtype == torch.bfloat16 else
            [flash_fwd_plan(B, T, D, n_heads).rows])
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    # q, k and v are read by 16-byte loads and cp.async
    q, k, v = _aligned16(q, k, v)
    out = torch.empty_like(q)
    lse = _empty(q.device, B, n_heads, T)
    _launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            sp, thresh, scale, out.data_ptr(), lse.data_ptr(), B, T, D,
            n_heads, *rows)
    return out, lse


def launch_flash_mha_bwd(q, k, v, mask, n_heads, seeds, drop_rate, out, lse,
                         g):
    """The flash backward kernels on flash_bwd_plan (P recomputed from lse):
    (dq, dk, dv) in q's dtype; for bf16 q, k, v, out and g the bf16 entry
    point (#14b, tensor cores) on flash_bwd_bf16_plan (lse, delta and the
    dQ partials float32 either way). CUDA tensors only."""
    name = _entry("flash_mha_bwd", _act_dtype("flash_mha_bwd", q))
    _require_cuda(name, q, k, v, mask, out, lse, g)
    B, T, D = _attention_shapes(name, q, k, v, mask, n_heads, out, g)
    _check(name, lse, (B, n_heads, T))
    plan = (flash_bwd_bf16_plan if q.dtype == torch.bfloat16 else
            flash_bwd_plan)(B, T, D, n_heads)
    sp, thresh, scale = _dropout_args(name, seeds, drop_rate, B)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # delta [B, H, T] (g . out per query), then the key tiles' dQ partials
    # [key_tiles, B, T, D]
    # (16-byte aligned: the kernel writes them as float4s)
    nd = -(-B * n_heads * T // 4) * 4
    work = _empty(q.device, nd + plan.workspace_bytes // 4)
    dqw = work[nd:]
    # the query (and bf16: key) tiles land by 16-byte cp.async
    q, k, g = _aligned16(q, k, g)
    _launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            sp, thresh, scale, out.data_ptr(), lse.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), work.data_ptr(),
            dqw.data_ptr(), B, T, D, n_heads)
    return dq, dk, dv


class FusedMHA(torch.autograd.Function):
    """fused_mha's whole-T route: forward kernel, backward kernel, which
    reads the forward's output; at either dtype."""

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
    the backward kernels; at either dtype."""

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


def mha_twin(q, k, v, mask, n_heads, seeds=None, drop_rate=0.0):
    """fused_mha's plain version at q's dtype, what the CPU runs: at
    float32 `attention` (the two routes' one fp32 function); at bf16 the
    twin of attention_route's bf16 kernels (whole_attention_plain or
    flash_attention_plain, which differ), through PlainMHA or
    PlainFlashMHA for a gradient."""
    if q.dtype != torch.bfloat16:
        return attention(q, k, v, mask, n_heads, seeds, drop_rate)
    whole = attention_route(q.shape[1], _head_dim(
        "mha_twin", q.shape[2], n_heads)) == "whole"
    if grad_wanted(q, k, v):
        return (PlainMHA if whole else PlainFlashMHA).apply(
            q, k, v, mask, n_heads, seeds, float(drop_rate))
    if whole:
        return whole_attention_plain(q, k, v, mask, n_heads, seeds, drop_rate)
    return flash_attention_plain(q, k, v, mask, n_heads, seeds, drop_rate)[0]


def fused_mha(q, k, v, mask, n_heads, seeds=None, drop_rate=0.0):
    """Attention through the whole-T or the flash kernels, as
    attention_route says, at q's dtype: on the card the kernels (bf16 q, k,
    v: #11b-#14b); on the CPU mha_twin."""
    name = "mha_fwd"
    tensors = [q, k, v, mask] + ([] if seeds is None else [seeds])
    if not _on_cuda(name, *tensors):
        return mha_twin(q, k, v, mask, n_heads, seeds, drop_rate)
    _act_dtype(name, q)
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
    """[B, T, W] score v.w4v + (q.w4q)^T + (v * w4mul).q^T; for bf16 video
    and query, the JAX package's CQAttention at bf16: the two vector
    products in bf16, the third on bf16 operands with fp32 accumulation,
    summed in fp32."""
    if video.dtype == torch.bfloat16:
        dt = video.dtype
        return ((video @ w4v.to(dt)).float()[:, :, None]
                + (query @ w4q.to(dt)).float()[:, None, :]
                + (video * w4mul.to(dt)).float()
                @ query.float().transpose(1, 2))
    return ((video @ w4v)[:, :, None] + (query @ w4q)[:, None, :]
            + (video * w4mul) @ query.transpose(1, 2))


def cqa_from_score(score, video, query, v_mask, q_mask):
    """The [B, T, 4d] concat from a trilinear score (which training forms
    from dropped inputs): masked row and column softmaxes (float32, cast to
    video's dtype), v2q, q2v."""
    score_q = torch.softmax(mask_logits(score, q_mask[:, None, :]),
                            dim=-1).to(video.dtype)
    score_v = torch.softmax(mask_logits(score, v_mask[:, :, None]),
                            dim=1).to(video.dtype)
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


# --- 7. where the kernels take a shape --------------------------------------------
# One predicate a wrapper, a pure function of the shape read from the
# port's own plans (never from the TPU's VMEM budgets): true where the
# wrapper's kernels take the shape on the card. The modules, serve.py and
# train/runner.py call a wrapper only where its predicate holds and run its
# plain version beyond it, as the JAX package runs XLA beyond its `*_fits`
# predicates; the wrappers keep refusing what their kernels cannot take.
# The highlight gate takes every shape.


def grad_wanted(*tensors):
    """True where a call on `tensors` records a gradient (training)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def _plans_take(*calls):
    """True where every (plan, *shape) of `calls` plans its shape: the plans
    raise ValueError on what their kernels cannot take."""
    try:
        for plan, *shape in calls:
            plan(*shape)
    except ValueError:
        return False
    return True


@functools.lru_cache(maxsize=256)
def lstm_kernel_fits(B, H):
    """csrc/lstm.cu takes B rows of hidden size H (lstm_plan,
    lstm_fwd_bf16_plan and lstm_bwd_bf16_plan: H up to LSTM_MAX_H)."""
    return _plans_take((lstm_plan, B, H), (lstm_fwd_bf16_plan, B, H),
                       (lstm_bwd_bf16_plan, B, H))


@functools.lru_cache(maxsize=256)
def conv_kernel_fits(T, D, K, L, grad=False, dtype=torch.float32):
    """The conv block kernels that conv_route picks for [T, D], K taps and L
    layers (with `grad`, the pair a training call takes) at activations of
    `dtype` fit their plans: the whole-row forward's and backward's, or the
    tiled forward's and backward's (the tiled forward also plans its
    backward), or at bf16 beyond them the wide pair's conv_wide_plan."""
    return (_conv_pair_fits(T, D, K, L, grad)
            or conv_route(T, D, K, L, grad, dtype) == "wide")


@functools.lru_cache(maxsize=256)
def _conv_pair_fits(T, D, K, L, grad=False):
    """conv_kernel_fits of the whole-row and tiled pairs, which take fp32
    and bf16 alike."""
    if min(T, K, L) < 1 or D < 4 or D % 4:
        return False
    if conv_route(T, D, K, L, grad) == "block":
        return _plans_take((conv_fwd_plan, 1, T, D, K, L),
                           (conv_plan, 1, T, D, K, L))
    return _plans_take((conv_tiled_fwd_plan, 1, T, D, K, L),
                       (conv_tiled_bwd_plan, 1, T, D, K, L),
                       (conv_tiled_fwd_bf16_plan, 1, T, D, K, L),
                       (conv_tiled_bwd_bf16_plan, 1, T, D, K, L))


@functools.lru_cache(maxsize=256)
def mha_kernel_fits(T, D, n_heads, dtype=torch.float32, grad=False):
    """fused_mha_block's kernels take [T, D] in n_heads heads at
    activations of `dtype`: a head dim of MHA_HEAD_DIMS, then the route's
    plans: the block kernels' (mha_route checks them), the whole-T
    forward's shared memory and mha_whole_bwd_plan, or the flash plans'
    shared memory (fp32 and bf16); at bf16 also a head dim of
    MHA_WIDE_HEAD_DIMS where mha_wide_plan takes the shape. Every route
    plans both directions, so `grad` (a training call) changes no
    answer."""
    if _wide_head_dim(D, n_heads):
        return (dtype == torch.bfloat16
                and _plans_take((mha_wide_plan, 1, T, D, n_heads)))
    if n_heads < 1 or D % n_heads or D // n_heads not in MHA_HEAD_DIMS:
        return False
    hd = D // n_heads
    route = mha_route(T, D, n_heads)
    if route == "block":
        return True
    if route == "whole":
        return (_mha_fwd_attention_bytes(T, min(T, MHA_WHOLE_QTILE), hd)
                <= MAX_SMEM_BYTES
                and _plans_take((mha_whole_bwd_plan, 1, T, D, n_heads)))
    return all(plan(1, T, D, n_heads).smem_bytes <= MAX_SMEM_BYTES
               for plan in (flash_fwd_plan, flash_bwd_plan,
                            flash_fwd_bf16_plan, flash_bwd_bf16_plan))


@functools.lru_cache(maxsize=256)
def cqa_kernel_fits(T, W, D):
    """csrc/cqa.cu takes T frames and a query of W words of width D
    (cqa_plan: W up to cqa_max_words at its tiles)."""
    return _plans_take((cqa_plan, 1, T, W, D))


def span_decode_kernel_fits(T):
    """csrc/span_decode.cu takes rows of T frames (up to
    SPAN_DECODE_MAX_T)."""
    return 1 <= T <= SPAN_DECODE_MAX_T


def span_decode(start_logits, end_logits, use_kernels=True):
    """Top-1 (start_idx, end_idx) a row: the kernel's wrapper where
    use_kernels and span_decode_kernel_fits hold, else its plain version."""
    if use_kernels and span_decode_kernel_fits(start_logits.shape[1]):
        return fused_span_decode(start_logits, end_logits)
    return span_decode_plain(start_logits, end_logits)
