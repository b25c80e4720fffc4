#!/usr/bin/env python3
"""Does torch.profiler keep a record of every kernel that its window holds?
For --seconds it profiles REPS calls of one bf16 product on the card again
and again, in turns with no pad and with common.PROFILE_PAD_S of host sleep
before the first launch and after the last synchronize (as by_kernel,
kernel_counts and paths.profile_device take their profiles):

    python3 -m vslnet_torch.bench.profiler_window [--seconds 300]

One JSON line every 20 s of the process: for each pad, the fewest kernel
records a profile kept of REPS and the least gap from a launch on the host
to its kernel's start on the card (negative where the card's clock, as the
profiler reads it, runs behind the host's). The last line sums the run:
for each pad, the profiles that kept fewer records than the most any kept.
"""
import json
import sys
import time

from vslnet_torch.bench.common import PROFILE_PAD_S, card

REPS = 10


def one_profile(fn, pad):
    """(kernel records kept, least launch-to-start gap in us) of REPS calls
    of fn, the window padded by pad seconds on each side."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    launches = [e for e in events if e.device_type == DeviceType.CPU
                and "LaunchKernel" in e.name]
    gap = (min(e.time_range.start for e in kernels)
           - min(e.time_range.start for e in launches)) if kernels and launches else None
    return len(kernels), gap


def main(argv):
    import torch

    seconds = float(argv[argv.index("--seconds") + 1]) if "--seconds" in argv else 300.0
    assert torch.cuda.is_available(), "profiler_window needs the card"
    a = torch.randn(32768, 1024, device="cuda").bfloat16()
    b = torch.randn(1024, 1024, device="cuda").bfloat16()
    fn = lambda: torch.matmul(a, b.t())  # noqa: E731
    pads = (0.0, PROFILE_PAD_S)
    t0 = time.perf_counter()
    seen = {pad: [] for pad in pads}
    window = {pad: [] for pad in pads}
    next_line = 20.0
    while time.perf_counter() - t0 < seconds:
        for pad in pads:
            kept, gap = one_profile(fn, pad)
            seen[pad].append((kept, gap))
            window[pad].append((kept, gap))
        at = time.perf_counter() - t0
        if at >= next_line:
            print(json.dumps({"s": at, **{
                "pad %g" % pad: {"profiles": len(w), "least_kept": min(k for k, _ in w),
                                 "least_gap_us": min((g for _, g in w if g is not None),
                                                     default=None)}
                for pad, w in window.items()}}), flush=True)
            window = {pad: [] for pad in pads}
            next_line += 20.0
    full = max(k for s in seen.values() for k, _ in s)
    print(json.dumps({"card": card(), "reps": REPS, "seconds": seconds, **{
        "pad %g" % pad: {"profiles": len(s), "most_kept": full,
                         "short": sum(k < full for k, _ in s),
                         "least_kept": min(k for k, _ in s)}
        for pad, s in seen.items()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
