"""Span decode inputs with planted ties, shared by chip_smoke.py's
`span_decode` row and the card tests (tests/test_torch_cuda.py).

Ties across the kernel's boundaries (csrc/span_decode.cu: 256 threads,
chunks of C frames a thread, 32 C frames a warp): at T = 128 (C = 1)
between threads and warps; at T = 1024 (C = 4) inside a thread's chunk,
between chunks, threads and warps, and between the two halves of the CTA;
an all-tied row, a fully masked row (answer (0, 0)), a best start and end
at the last valid frame, and untouched rows. Each row is (length, start
frames, end frames)."""
import numpy as np

SPAN_TIES_128 = [(128, (31, 32), (63, 64)), (128, (0, 1), (126, 127)),
                 (0, (), ()), (100, (99,), (99,)),
                 (128, tuple(range(128)), tuple(range(128))),
                 (77, (5, 6), (32, 33)), (128, (95, 96), (96, 97)),
                 (128, (), ())] * 2
SPAN_TIES_1024 = [(1024, (3, 4), (7, 8)), (1024, (127, 128), (255, 256)),
                  (1024, (31, 32), (511, 512)), (0, (), ()),
                  (1024, tuple(range(1024)), tuple(range(1024))),
                  (700, (699,), (699,)), (1024, (1, 2), (1022, 1023)),
                  (900, (639, 640), (899,))]


def span_tie_logits(rng, T, rows):
    """Start and end logits [len(rows), T] (float32) of N(0, 3) noise with
    planted ties: the frames in a row's starts (ends) get a start (end)
    logit of 20, the row's best, so that neighbouring ones tie exactly;
    frames from the row's length on are masked (-1e30)."""
    B = len(rows)
    sl = (rng.standard_normal((B, T)) * 3).astype(np.float32)
    el = (rng.standard_normal((B, T)) * 3).astype(np.float32)
    for r, (n, starts, ends) in enumerate(rows):
        sl[r, list(starts)] = 20.0
        el[r, list(ends)] = 20.0
        sl[r, n:] = -1e30
        el[r, n:] = -1e30
    return sl, el


def span_ties_expected(rows):
    """What each row of span_tie_logits decodes to: (first planted start,
    first planted end), (0, 0) where the row is fully masked, None where
    nothing was planted."""
    return [(0, 0) if n == 0 else (s[0], e[0]) if s and e else None
            for n, s, e in rows]
