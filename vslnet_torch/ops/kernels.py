"""Hand-written CUDA kernels for the serving path, with their plain PyTorch
versions and launch counters. The counterpart of the JAX package's
ops/pallas_kernels.py.

Each wrapper below takes the plain version for tensors on the CPU (the
tests) and launches its kernel for tensors on a CUDA device; there it
raises on anything the kernel does not take and never falls back. The
plain versions also serve the model under `use_pallas=off`.

The kernels (csrc/*.cu, sm_90a, fp32) are compiled with nvcc into one
shared library with a plain C interface, one nvcc process per source, all
started together, at the first launch (or by `build_library`), into
vslnet_torch/_build/, and bound with ctypes. Nothing is built at import.

Dropout inside the kernels (the JAX package's counter hash) belongs to
training and is not ported yet: every wrapper raises for drop_rate > 0.
"""
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

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

# launches of each kernel since the last reset_launches(); a wrapper adds one
# where it launches its kernel and nowhere else
LAUNCHES = {"lstm_recurrence_fwd": 0, "conv_block_fwd": 0,
            "mha_block_fwd": 0, "cqa_concat_fwd": 0, "highlight_gate_fwd": 0,
            "span_decode": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --- build and load ----------------------------------------------------------

_LIB = None
_LIB_LOCK = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "vsl_lstm_recurrence_fwd": [_P, _P, _P, _P, _I, _I, _I, _P],
    "vsl_conv_block_fwd": [_P] * 7 + [_I] * 5 + [_P],
    "vsl_mha_block_fwd": [_P] * 11 + [_I] * 4 + [_P],
    "vsl_cqa_concat_fwd": [_P] * 8 + [_I] * 4 + [_P],
    "vsl_highlight_gate_fwd": [_P] * 6 + [_I] * 2 + [_P],
    "vsl_span_decode": [_P] * 4 + [_I] * 2 + [_P],
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


def _check(name, t, shape):
    if t.dtype != torch.float32:
        raise TypeError("%s: expected float32, got %s" % (name, t.dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s: expected shape %s, got %s"
                         % (name, tuple(shape), tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s: tensor must be contiguous" % name)


def _no_dropout(name, drop_rate):
    if drop_rate > 0.0:
        raise NotImplementedError(
            "%s: dropout inside the kernel (drop_rate > 0) comes with the "
            "training kernels, which are not ported yet" % name)


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


def attention(q, k, v, mask, n_heads):
    """Multi-head attention without an output projection: q, k, v [B, T, D],
    key mask [B, T] added as (1 - m) * -1e30, fp32 softmax."""
    B, T, D = q.shape
    hd = D // n_heads

    def split(t):
        return t.reshape(B, T, n_heads, hd).transpose(1, 2)

    s = (split(q) * (1.0 / math.sqrt(float(hd)))) @ split(k).transpose(-1, -2)
    s = s + (1.0 - mask.to(torch.float32)).reshape(B, 1, 1, T) * -1e30
    out = torch.softmax(s, dim=-1) @ split(v)
    return out.transpose(1, 2).reshape(B, T, D)


# --- 1. LSTM recurrence --------------------------------------------------------
# Replaces vslnet_tpu/ops/pallas_kernels.py:_lstm_fwd_lean_kernel (via
# fused_lstm_recurrence). Kernel: csrc/lstm.cu. Bound on the H100 by its
# chain of T dependent steps on B SMs, not by bytes or FLOPs; one launch
# runs all T steps with h and c in shared memory.


def lstm_recurrence_plain(x_proj, k_h, valid):
    """[T, B, 4H] pre-projected inputs, [H, 4H] recurrent kernel, [T, B]
    validity -> [T, B, H]; TF gates [i, j, f, o], forget bias 1, state
    frozen and output zeroed where valid is 0."""
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


def fused_lstm_recurrence(x_proj, k_h, valid):
    name = "lstm_recurrence_fwd"
    if not _on_cuda(name, x_proj, k_h, valid):
        return lstm_recurrence_plain(x_proj, k_h, valid)
    T, B, G = x_proj.shape
    H = G // 4
    if G != 4 * H or not 1 <= H <= 256:
        raise ValueError("%s: needs x_proj [T, B, 4H] with H <= 256 (4H "
                         "threads a block), got %s" % (name, tuple(x_proj.shape)))
    _check(name, x_proj, (T, B, 4 * H))
    _check(name, k_h, (H, 4 * H))
    _check(name, valid, (T, B))
    out = torch.empty(T, B, H, device=x_proj.device, dtype=torch.float32)
    _launch(name, x_proj.data_ptr(), k_h.data_ptr(), valid.data_ptr(),
            out.data_ptr(), T, B, H)
    return out


# --- 2. conv block -------------------------------------------------------------
# Replaces vslnet_tpu/ops/pallas_kernels.py:_make_conv_block_fwd_kernel (via
# fused_conv_block). Kernel: csrc/conv_block.cu. Bound by the pointwise
# products on the B SMs that hold a row; all L layers run in one launch with
# the row's activations in shared memory.


def conv_block_plain(x, gam, beta, dw, wp, bp):
    """L x {x + relu(pointwise(depthwise(LN(x))) + bp)}: x [B, T, D],
    gam/beta/bp [L, D], dw [L, k, D], wp [L, D, D]."""
    for l in range(gam.shape[0]):
        x = x + depthwise_separable(layer_norm(x, gam[l], beta[l]), dw[l],
                                    wp[l], bp[l])
    return x


def conv_block_smem_bytes(T, D):
    return 3 * T * D * 4


def fused_conv_block(x, gam, beta, dw, wp, bp, drop_rate=0.0):
    name = "conv_block_fwd"
    _no_dropout(name, drop_rate)
    if not _on_cuda(name, x, gam, beta, dw, wp, bp):
        return conv_block_plain(x, gam, beta, dw, wp, bp)
    B, T, D = x.shape
    L, K, _ = dw.shape
    if D % 4:
        raise ValueError("%s: needs D %% 4 == 0, got D=%d" % (name, D))
    if conv_block_smem_bytes(T, D) > MAX_SMEM_BYTES:
        raise ValueError("%s: T=%d, D=%d needs %d bytes of shared memory, "
                         "above the %d a block has" % (
                             name, T, D, conv_block_smem_bytes(T, D),
                             MAX_SMEM_BYTES))
    _check(name, x, (B, T, D))
    for t in (gam, beta, bp):
        _check(name, t, (L, D))
    _check(name, dw, (L, K, D))
    _check(name, wp, (L, D, D))
    out = torch.empty_like(x)
    _launch(name, x.data_ptr(), gam.data_ptr(), beta.data_ptr(), dw.data_ptr(),
            wp.data_ptr(), bp.data_ptr(), out.data_ptr(), B, T, D, L, K)
    return out


# --- 3. MHA block --------------------------------------------------------------
# Replaces vslnet_tpu/ops/pallas_kernels.py:_make_mha_block_fwd_kernel (via
# fused_mha_block). Kernel: csrc/mha_block.cu, three launches (LN1 + QKV,
# per-(row, head) attention, residual + LN2 + dense + residual). Bound by
# the projections on few SMs and the attention's serial key loop.


def mha_block_plain(x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads):
    """Pre-LN attention block: x [B, T, D], key mask [B, T], gam/beta [2, D]
    (LN1, LN2), wqkv [D, 3D], bqkv [3D], wd [D, D], bd [D]."""
    D = x.shape[-1]
    qkv = layer_norm(x, gam[0], beta[0]) @ wqkv + bqkv
    res = attention(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], mask,
                    n_heads) + x
    return layer_norm(res, gam[1], beta[1]) @ wd + bd + res


MHA_HEAD_DIMS = (8, 16, 32, 64)


def mha_block_smem_bytes(T, D):
    """The largest of the three launches' shared memory (the attention's
    K, V and mask rows fit under 2*T*D + T floats for any head count)."""
    return (2 * D + 1) * T * 4


def fused_mha_block(x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads,
                    drop_rate=0.0):
    name = "mha_block_fwd"
    _no_dropout(name, drop_rate)
    if not _on_cuda(name, x, mask, gam, beta, wqkv, bqkv, wd, bd):
        return mha_block_plain(x, mask, gam, beta, wqkv, bqkv, wd, bd, n_heads)
    B, T, D = x.shape
    if D % n_heads or D // n_heads not in MHA_HEAD_DIMS:
        raise ValueError("%s: head dim D/n_heads must be one of %s, got D=%d "
                         "heads=%d" % (name, MHA_HEAD_DIMS, D, n_heads))
    if mha_block_smem_bytes(T, D) > MAX_SMEM_BYTES:
        raise ValueError("%s: T=%d, D=%d needs %d bytes of shared memory, "
                         "above the %d a block has" % (
                             name, T, D, mha_block_smem_bytes(T, D),
                             MAX_SMEM_BYTES))
    _check(name, x, (B, T, D))
    _check(name, mask, (B, T))
    _check(name, gam, (2, D))
    _check(name, beta, (2, D))
    _check(name, wqkv, (D, 3 * D))
    _check(name, bqkv, (3 * D,))
    _check(name, wd, (D, D))
    _check(name, bd, (D,))
    qkv = torch.empty(B, T, 3 * D, device=x.device, dtype=torch.float32)
    att = torch.empty_like(x)
    out = torch.empty_like(x)
    _launch(name, x.data_ptr(), mask.data_ptr(), gam.data_ptr(),
            beta.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wd.data_ptr(),
            bd.data_ptr(), qkv.data_ptr(), att.data_ptr(), out.data_ptr(),
            B, T, D, n_heads)
    return out


# --- 4. span decode ------------------------------------------------------------
# Replaces vslnet_tpu/ops/pallas_kernels.py:_span_decode_kernel (via
# fused_span_decode). Kernel: csrc/span_decode.cu. Launch-bound; one block
# per row, and the [T, T] banded product is replaced by exact prefix and
# suffix maxima.


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
    if (2 * T + 32) * 4 > 48 * 1024:  # the default dynamic shared memory
        raise ValueError("%s: T=%d does not fit shared memory" % (name, T))
    s_idx = torch.empty(B, device=start_logits.device, dtype=torch.int32)
    e_idx = torch.empty_like(s_idx)
    _launch(name, start_logits.data_ptr(), end_logits.data_ptr(),
            s_idx.data_ptr(), e_idx.data_ptr(), B, T)
    return s_idx, e_idx


# --- 5. context-query attention ----------------------------------------------
# Replaces vslnet_tpu/ops/pallas_kernels.py:_cqa_kernel (via
# fused_cqa_concat). Kernel: csrc/cqa.cu. Bound by its B blocks (one a
# batch row) more than by its bytes, which are mostly the [B, T, 4d]
# output; the score matrices and Sv^T.v stay in shared memory.


def cqa_plain(video, query, v_mask, q_mask, w4v, w4q, w4mul):
    """Context-query attention up to its output projection: video [B, T, d],
    query [B, W, d], masks [B, T] / [B, W], w4v, w4q, w4mul [d] ->
    ([B, T, 4d] concat [v, v2q, v*v2q, v*q2v], [B, T, W] trilinear score)."""
    score = ((video @ w4v)[:, :, None] + (query @ w4q)[:, None, :]
             + (video * w4mul) @ query.transpose(1, 2))
    score_q = torch.softmax(mask_logits(score, q_mask[:, None, :]), dim=-1)
    score_v = torch.softmax(mask_logits(score, v_mask[:, :, None]), dim=1)
    v2q = score_q @ query
    q2v = score_q @ (score_v.transpose(1, 2) @ video)
    return torch.cat([video, v2q, video * v2q, video * q2v], dim=-1), score


def cqa_smem_bytes(T, W, D):
    return (2 * T * W + 2 * W * D + W) * 4


def fused_cqa_concat(video, query, v_mask, q_mask, w4v, w4q, w4mul):
    """[B, T, 4d] CQA concat (no score: the kernel never writes it out)."""
    name = "cqa_concat_fwd"
    if not _on_cuda(name, video, query, v_mask, q_mask, w4v, w4q, w4mul):
        return cqa_plain(video, query, v_mask, q_mask, w4v, w4q, w4mul)[0]
    B, T, D = video.shape
    W = query.shape[1]
    if cqa_smem_bytes(T, W, D) > MAX_SMEM_BYTES:
        raise ValueError("%s: T=%d, W=%d, D=%d needs %d bytes of shared "
                         "memory, above the %d a block has" % (
                             name, T, W, D, cqa_smem_bytes(T, W, D),
                             MAX_SMEM_BYTES))
    _check(name, video, (B, T, D))
    _check(name, query, (B, W, D))
    _check(name, v_mask, (B, T))
    _check(name, q_mask, (B, W))
    for w in (w4v, w4q, w4mul):
        _check(name, w, (D,))
    out = torch.empty(B, T, 4 * D, device=video.device, dtype=torch.float32)
    _launch(name, video.data_ptr(), query.data_ptr(), v_mask.data_ptr(),
            q_mask.data_ptr(), w4v.data_ptr(), w4q.data_ptr(),
            w4mul.data_ptr(), out.data_ptr(), B, T, W, D)
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
