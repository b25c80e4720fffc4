"""Context-query attention's launch plan (ops/kernels.py cqa_plan), on the
CPU: a row's CTAs cover its frames once, none empty, at most CQA_CTAS of
them; the plan fits a block's shared memory, takes queries up to the
limit it names and raises only beyond it. Also the port's CQAttention
with use_kernels in eval mode, which on the CPU runs cqa_plain, against
flax's CQAttention(use_pallas=True) at a shape where the JAX package's own
gate (cqa_pallas_fits) sends it to XLA: both compute the same function.
The kernel itself is held to cqa_plain by the card tests
(tests/test_torch_cuda.py)."""
import jax
import numpy as np
import pytest
import torch

from test_torch_cuda import _cqa_inputs
from vslnet_torch.bench import cqa_plans
from vslnet_torch.convert_flax import load_flax_variables
from vslnet_torch.models import layers as P
from vslnet_torch.ops import kernels

torch.set_num_threads(1)


@pytest.mark.parametrize("W", [1, 7, 12, 64, 160])
@pytest.mark.parametrize("T", [1, 5, 12, 20, 128, 192, 1000, 1024])
def test_cqa_plan_covers_every_frame_once(T, W):
    """Every length the card tests and the paths run: CTA r of a row owns
    [r F, min(T, (r + 1) F)), all of T once, none empty; at most CQA_CTAS
    CTAs a row and enough that B rows fill the card's SMs once where T
    allows; the plan's bytes are CqaLayout's and fit a block."""
    for B in (1, 2, 8, 16, 33, 200):
        try:
            plan = kernels.cqa_plan(B, T, W, 128)
        except ValueError:
            top = min(kernels.CQA_CTAS, T)
            assert W > kernels.cqa_max_words(-(-T // top), 128)
            continue
        assert 1 <= plan.n <= kernels.CQA_CTAS
        assert plan.ctas == B * plan.n
        frames = [t for r in range(plan.n)
                  for t in range(r * plan.frames, min(T, (r + 1) * plan.frames))]
        assert frames == list(range(T))
        assert (plan.n - 1) * plan.frames < T
        assert plan.smem == kernels._cqa_smem_bytes(plan.frames, W, 128)
        assert plan.smem <= kernels.MAX_SMEM_BYTES
        n = min(T, kernels.CQA_CTAS, max(1, kernels.N_SMS // B))
        assert plan.frames <= -(-T // n)


@pytest.mark.parametrize("B,T,W,want", [
    (8, 1024, 12, (16, 64, 48528, 128)),
    (16, 128, 12, (8, 16, 21456, 128)),
    (8, 1024, 64, (16, 64, 115712, 128)),
    (8, 1024, 160, (18, 57, 231652, 144)),
    (16, 1024, 64, (8, 128, 165120, 128)),
    (16, 1024, 160, (18, 57, 231652, 288)),
    (4, 1000, 40, (33, 31, 62396, 132)),
    (2, 128, 200, (64, 2, 209832, 128))])
def test_cqa_plan_at_the_paths(B, T, W, want):
    """Path L's [8, 1024] at the served query length: 16 CTAs of 64 frames
    a row, 128 CTAs; the served [16, 128]: 8 of 16; W = 64 and 160 at T =
    1024 fit, 160 words by more CTAs a row than the card needs (18 of 57
    frames); a ragged last tile at T = 1000 (33 CTAs of 31 frames, the
    last 8); W = 200 at T = 128, which the one-block-a-row kernel refused,
    in 64 CTAs of 2 frames."""
    plan = kernels.cqa_plan(B, T, W, 128)
    assert (plan.n, plan.frames, plan.smem, plan.ctas) == want


def test_cqa_plan_raises_only_beyond_its_limit():
    """At D = 128 a CTA of F frames takes a query of up to (58,112 - 129 F)
    / (259 + F) words: 154 at 64 frames, 185 at 32, 203 at 16, the 64 CTAs
    a row of T = 1024, so 203 fits there, whatever B, and 204 raises,
    naming the limit (the one-block-a-row kernel's was 25). At T = 128, 2
    frames a CTA: 221."""
    assert [kernels.cqa_max_words(f, 128) for f in (64, 32, 16, 2)] == \
        [154, 185, 203, 221]
    for B in (1, 8, 16):
        assert kernels.cqa_plan(B, 1024, 203, 128).frames == 16
        with pytest.raises(ValueError, match="shared memory.*W up to 203 fits"):
            kernels.cqa_plan(B, 1024, 204, 128)
    kernels.cqa_plan(2, 128, 221, 128)
    with pytest.raises(ValueError, match="W up to 221 fits"):
        kernels.cqa_plan(2, 128, 222, 128)


@pytest.mark.parametrize("B,T,W,D", [(0, 128, 12, 128), (16, 0, 12, 128),
                                     (16, 128, 0, 128), (16, 128, 12, 2),
                                     (16, 128, 12, 30)])
def test_cqa_plan_refuses(B, T, W, D):
    with pytest.raises(ValueError, match="cqa_plan"):
        kernels.cqa_plan(B, T, W, D)


def test_cqa_bench_plans_and_copies():
    """vslnet_torch/bench/cqa_plans.py times cqa_plan's plan among the CTA
    counts that fit, each as the kernel's two launches and, up to 16 CTAs
    a row, as one cluster launch, and builds copies of csrc/cqa.cu: with
    another thread count, whose constant it finds once in the shipped
    kernel; with the cluster form appended, which calls the shipped
    kernel's steps by name; and with clock stamps between the barriers of
    the two launches."""
    for B, T, W, D in cqa_plans.SHAPES:
        plans = cqa_plans.plans(B, T, W, D)
        plan = kernels.cqa_plan(B, T, W, D)
        assert (plan, "two") in plans and (plan, "cluster") in plans
        assert len(plans) == len(set(plans))
        assert all(p.smem <= kernels.MAX_SMEM_BYTES and (p.n - 1) * p.frames < T
                   and p.n <= (kernels.CQA_CTAS if form == "two"
                               else cqa_plans.CLUSTER) for p, form in plans)
    src = (kernels.CSRC / "cqa.cu").read_text()
    for name in ("struct CqaArgs", "struct CqaLayout", "struct Tile",
                 "Tile tile_of(", "void partials(", "void row_softmax(",
                 "void first_quarters(", "void combine(", "void last_quarter(",
                 "constexpr int kThreads"):
        assert name in src, name
    assert "cqa_cluster_kernel" not in src and "barrier.cluster" not in src
    cluster = cqa_plans.renamed(src, "cqa1") + cqa_plans.CLUSTER_FORM
    assert cluster.count('extern "C" int cqa1_cqa_concat_fwd(') == 1
    assert cluster.count('extern "C" int cluster_concat_fwd(') == 1
    assert "constexpr int kThreads = %d;" % kernels.CQA_THREADS in src
    assert cqa_plans.THREADS[0] == kernels.CQA_THREADS
    for n in cqa_plans.THREADS[1:]:
        assert "constexpr int kThreads = %d;" % n in cqa_plans.with_threads(src, n)
    assert 'extern "C" int vsl_cqa_concat_fwd(' in src
    # the stamped copy: a stamp at each barrier of the partials step and of
    # the two-launch kernels and at each kernel's last line, keyed by a
    # line of the shipped source
    prof, stamped = cqa_plans.instrumented(src)
    lines = src.split("\n")
    assert stamped == sorted(set(stamped)) and len(stamped) >= 6
    assert prof.count("+= now - g_last") == len(stamped)
    assert prof.count("g_last = clock64();") == 2
    assert sum("__syncthreads();" not in lines[n - 1] for n in stamped) == 2
    assert 'extern "C" int cprof_cqa_concat_fwd(' in prof


def test_cqa_cpu_path_matches_flax_beyond_its_gate():
    """The port's CQAttention(use_kernels=True) in eval mode on the CPU,
    where fused_cqa_concat runs cqa_plain (so this holds cqa_plain, not the
    CUDA kernel; the card tests in tests/test_torch_cuda.py hold the kernel
    against cqa_plain), against flax CQAttention(use_pallas=True,
    deterministic) at D = 16, B = 2, T = 1200, W = 40, where
    cqa_pallas_fits is false and the JAX package takes its XLA path; row 1
    has every frame masked (a uniform column softmax) and a ragged query.
    fp32 both sides, sums in another order: 1e-5."""
    from vslnet_tpu.models import layers as J
    from vslnet_tpu.ops.pallas_kernels import cqa_pallas_fits

    B, T, W, D = 2, 1200, 40, 16
    assert not cqa_pallas_fits(B, T, W, D)
    rng = np.random.default_rng(41)
    video, query, v_mask, q_mask = _cqa_inputs(rng, B, T, W, D, [1100, 0],
                                               [40, 17])[:4]
    kw = {"deterministic": True, "drop_rate": 0.0}
    mod = J.CQAttention(dim=D, use_pallas=True)
    variables = mod.init(jax.random.PRNGKey(0), video, query, v_mask, q_mask,
                         **kw)
    variables = jax.tree.map(
        lambda a: (np.asarray(a) + 0.3 * rng.standard_normal(a.shape))
        .astype(np.float32), variables)
    ref = np.asarray(mod.apply(variables, video, query, v_mask, q_mask,
                               **kw)[0])
    twin = load_flax_variables(P.CQAttention(D, use_kernels=True),
                               variables).eval()
    kernels.reset_launches()
    with torch.no_grad():
        out, score = twin(*map(torch.from_numpy,
                               (video, query, v_mask, q_mask)))
    assert score is None and not any(kernels.LAUNCHES.values())
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
