"""What the card-only scripts of vslnet_torch/bench share: CUDA-event
timing, time by kernel, the card's name and power limit, a copy of a kernel
source with clock stamps, and building a changed copy of a kernel source
into a library of its own."""
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


def by_kernel(fn, reps=10):
    """{kernel name, cut to 60 characters: device ms a call of fn}, from
    torch.profiler over reps calls after one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


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
