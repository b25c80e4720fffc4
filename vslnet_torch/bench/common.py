"""What the card-only scripts of vslnet_torch/bench share: CUDA-event
timing, time and launches by kernel from padded profiles, the card's name and power limit, a copy of a kernel
source with clock stamps, and building a changed copy of a kernel source
into a library of its own, which the wrappers then call in place of the
package's."""
import ctypes
import subprocess

from vslnet_torch.ops import kernels as K


def cuda_ms(fn, reps=20, warmup=3):
    """Device ms a call of fn: CUDA events around reps calls, after warmup
    calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# host sleep on each side of a profile's window: torch.profiler reads the
# card's timestamps up to milliseconds behind the host's and keeps no record
# of a kernel that then seems to start before the window (PERF.md §7;
# bench/profiler_window.py reads it)
PROFILE_PAD_S = 0.05


def profiled(fn, reps):
    """torch.profiler's events of reps calls of fn, after one, the window
    padded by PROFILE_PAD_S on each side: [(name, device type, device ms,
    records)] from key_averages."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    return [(e.key, e.device_type, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()]


def by_kernel(fn, reps=10):
    """{kernel name, cut to 60 characters: device ms a call of fn}, from
    profiled(fn, reps); the kernels whose names agree in those characters
    (instantiations of one template) summed."""
    from torch.autograd import DeviceType

    out = {}
    for key, device, ms, _ in profiled(fn, reps):
        if device == DeviceType.CUDA:
            out[key[:60]] = out.get(key[:60], 0.0) + ms / reps
    return out


def kernel_counts(fn, reps=3):
    """{kernel name, cut to 60 characters: launches a call of fn}, from
    profiled(fn, reps) (by_kernel's names)."""
    from torch.autograd import DeviceType

    out = {}
    for key, device, _, count in profiled(fn, reps):
        if device == DeviceType.CUDA:
            out[key[:60]] = out.get(key[:60], 0) + count / reps
    return out


# H100 SXM peaks (NVIDIA data sheet, 700 W), FLOP/s by operand type: fp32
# outside the tensor cores, bf16 on them (dense); the memory rate is
# K.HBM_BYTES_PER_S
PEAK_FLOPS = {"fp32": 67e12, "bf16": K.PEAK_BF16_FLOPS}


def bound_ms(work, nbytes):
    """(the least ms the card could take for a function, "operations" or
    "bytes"): work {"fp32" or "bf16": the FLOPs done at that type's peak},
    nbytes the bytes it must move (each input read once, each output
    written once) over the HBM's rate."""
    t_ops = sum(f / PEAK_FLOPS[kind] for kind, f in work.items())
    t_bytes = nbytes / K.HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def conv_fwd_bf16_work(B, T, D, KS, L):
    """(work, nbytes) of the bf16 conv block forward, the function: the
    pointwise products on the tensor cores, the depthwise taps in fp32; x
    read and out written in bf16, the fp32 weights read. The layer inputs
    and ReLU masks the port's training route keeps are not the function's
    output and are not counted."""
    btd = B * T * D
    return ({"bf16": L * 2 * btd * D, "fp32": L * 2 * btd * KS},
            2 * 2 * btd + 4 * L * (3 * D + KS * D + D * D))


def conv_fwd_bf16_bound(B, T, D, KS, L):
    """bound_ms of conv_fwd_bf16_work."""
    return bound_ms(*conv_fwd_bf16_work(B, T, D, KS, L))


def mha_fwd_bf16_work(B, T, D, keys):
    """(work, nbytes) of the bf16 MHA block forward, the function: the two
    projections and the attention over `keys` keys in all (summed over the
    rows: a row's unmasked keys, all T for a fully masked row) on the
    tensor cores; x read and out written in bf16, the key mask and the fp32
    weights read. The qkv and att the port keeps for the backward are not
    the function's output and are not counted."""
    return ({"bf16": 2 * B * T * D * 4 * D + 4 * T * keys * D},
            2 * 2 * B * T * D + 4 * B * T + 4 * (4 * D * D + 8 * D))


def mha_fwd_bf16_bound(B, T, D, keys):
    """bound_ms of mha_fwd_bf16_work."""
    return bound_ms(*mha_fwd_bf16_work(B, T, D, keys))


def conv_bwd_bf16_work(B, T, D, KS, L):
    """(work, nbytes) of the bf16 conv block backward, the function (the
    JAX package's VJP, which saves only x and the weights): the replay's,
    g_d's and dwp's products on the tensor cores, the depthwise pass, its
    transpose and ddw in fp32; x and g read and dx written in bf16, the
    fp32 weights read and their gradients written. The layer inputs and
    ReLU masks the port keeps between the two directions are not counted."""
    btd = B * T * D
    return ({"bf16": L * 3 * 2 * btd * D, "fp32": L * 3 * 2 * btd * KS},
            3 * 2 * btd + 2 * 4 * L * (3 * D + KS * D + D * D))


def conv_bwd_bf16_bound(B, T, D, KS, L):
    """bound_ms of conv_bwd_bf16_work."""
    return bound_ms(*conv_bwd_bf16_work(B, T, D, KS, L))


def mha_bwd_bf16_work(B, T, D, keys):
    """(work, nbytes) of the bf16 MHA block backward, the function: g_z,
    g_y, dwd and dwqkv (16 B T D^2 FLOPs) and the attention's five products
    over `keys` keys in all (summed over the rows: a row's unmasked keys,
    all T for a fully masked row) on the tensor cores; x and g read and dx
    written in bf16, the key mask read, the fp32 weights (gam, beta, Wqkv,
    bqkv, Wd, bd) read and their gradients written. The qkv and att the
    port keeps from the forward are not counted."""
    return ({"bf16": 16 * B * T * D * D + 10 * T * keys * D},
            3 * 2 * B * T * D + 4 * B * T + 2 * 4 * (4 * D * D + 8 * D))


def mha_bwd_bf16_bound(B, T, D, keys):
    """bound_ms of mha_bwd_bf16_work."""
    return bound_ms(*mha_bwd_bf16_work(B, T, D, keys))


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def instrumented(src, kernel, stamps):
    """(src, a csrc/*.cu source, with a clock stamp, thread 0 of CTA 0, at
    each line of the kernel `kernel` that holds one of `stamps`, its entry
    points renamed prof_ and prof_read(h) added, which copies the 64
    counters to h and zeroes them; the source line of each stamp)."""
    lines = src.split("\n")
    first = next(i for i, ln in enumerate(lines) if ln.startswith(kernel + "("))
    last = lines.index("}", first)
    stamp = (" { if (threadIdx.x == 0 && blockIdx.x == 0) { long long now = "
             "clock64(); g_prof[%d] += now - plast; plast = now; } }")
    at = []
    for i in range(first, last):
        if any(m in lines[i] for m in stamps):
            lines[i] = lines[i].split("//")[0].rstrip() + stamp % len(at)
            at.append(i + 1)
    body_open = next(i for i in range(first, last) if lines[i].endswith(") {"))
    lines[body_open] += "\n  long long plast = clock64();"
    src = "\n".join(lines).replace(
        '#include "hash.cuh"\n', '#include "hash.cuh"\n'
        "__device__ unsigned long long g_prof[64];\n", 1)
    src = src.replace('extern "C" int vsl_', 'extern "C" int prof_')
    return src + r'''
extern "C" int prof_read(unsigned long long* h) {
  const int err = (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));
  unsigned long long z[64] = {0};
  return err ? err : (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
''', at


def build_copies(sources):
    """{name: src}, changed copies of csrc/*.cu sources, each built with the
    package's nvcc flags into vslnet_torch/_build/bench/lib<name>.so, one
    nvcc each, all started together: {name: the loaded library}."""
    out_dir = K.BUILD_DIR / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        path = out_dir / ("%s.cu" % name)
        path.write_text(src)
        lib_path = out_dir / ("lib%s.so" % name)
        procs[name] = (lib_path, subprocess.Popen(
            [K._nvcc(), *[f for f in K.NVCC_FLAGS if f not in ("-Xptxas", "-v")],
             "-shared", "-I", str(K.CSRC), "-o", str(lib_path), str(path)]))
    for name, (_, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError("nvcc failed on the bench copy %s" % name)
    return {name: ctypes.CDLL(str(lib_path)) for name, (lib_path, _) in procs.items()}


def build_copy(name, src):
    """build_copies of one source: its loaded library."""
    return build_copies({name: src})[name]


def edited_source(name, source, edits, inline=()):
    """csrc/<source> with each header of `inline` put in place of its
    #include (so that an edit can reach into it), changed by edits [(old,
    new)], each old found once, and its entry points renamed fault_."""
    src = (K.CSRC / source).read_text()
    for header in inline:
        src = src.replace('#include "%s"\n' % header, (K.CSRC / header).read_text(), 1)
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError("%s: the anchor %r is not found once in %s"
                               % (name, old, source))
        src = src.replace(old, new)
    return src.replace('extern "C" int vsl_', 'extern "C" int fault_')


def library_with(copy, entries):
    """The kernel library with vsl_<entry>, for each of entries, taken from
    the built copy's fault_<entry>."""
    fns = {}
    for entry in entries:
        fn = getattr(copy, "fault_" + entry)
        fn.argtypes = K._SIGNATURES["vsl_" + entry]
        fn.restype = ctypes.c_int
        fns["vsl_" + entry] = fn
    main = K._library()

    class Lib:
        def __getattr__(self, attr):
            return fns[attr] if attr in fns else getattr(main, attr)
    return Lib()


def edited_library(name, source, entries, edits, inline=()):
    """library_with the copy of edited_source(...) built on its own."""
    return library_with(build_copy(name, edited_source(name, source, edits, inline)),
                        entries)


def with_library(lib, fn):
    """fn() with lib swapped in for the wrappers' calls."""
    main, K._LIB = K._LIB, lib
    try:
        return fn()
    finally:
        K._LIB = main
