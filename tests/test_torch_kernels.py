"""Hand-written CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one; the kernel modules import nothing CUDA-specific until a launch, so
the file still collects on the CPU. Run on the card with::

    python -m pytest tests/test_torch_kernels.py -q

Tolerances: the decode and windowed-relaxation kernels must be bit-identical to the scatter twin
(its arithmetic is mins and adds in the reference's order). The MFCC
kernel computes its own f32 FFT and sums the mel bands in another order
than the twin's rfft and cuBLAS, so it is held to rtol 2e-3 / atol 3e-2 --
the tolerance the JAX package holds its own DFT-as-matmul kernel to
against rfft (tests/test_pallas_mfcc.py). Against the float64
``mfcc_numpy`` it is held, at both of its bodies (the power-of-two FFT and
Bluestein's algorithm for an odd window), to the allowance of
``rhasspy_speech_torch/testing/feature_tolerance.py``.
"""

import numpy as np
import pytest
import torch

from rhasspy_speech_torch.graph.dense import NEG_INF_F32, DenseGraph
from rhasspy_speech_torch.ops.decoder import DecodeGraph, viterbi, backtrace
from rhasspy_speech_torch.ops.frontend import (
    FrontendConfig,
    make_frontend_params,
    mfcc_batch_torch,
    mfcc_numpy,
)
from rhasspy_speech_torch.ops.mfcc_cuda import mfcc_batch
from rhasspy_speech_torch.ops.viterbi_cuda import (
    CLUSTER_SIZES,
    LARGE_CLUSTER_SIZES,
    H100_MAX_SMEM,
    alpha_fits,
    launch,
    max_clusters,
    plan_global,
    plan_halo,
    plan_viterbi,
    select_plan,
    smem_layout,
    viterbi_decode,
    viterbi_decode_checkpointed,
)
from rhasspy_speech_torch.testing.decode_graphs import random_decode_graph
from rhasspy_speech_torch.ops import windowed_relax_cuda
from rhasspy_speech_torch.ops.windowed_relax_cuda import (
    prepare_steps,
    windowed_relax,
    windowed_relax_torch,
)
from rhasspy_speech_torch.examples.windowed_cost import make_step_tables
from rhasspy_speech_torch.testing.feature_tolerance import (
    assert_mfcc_close,
    frames_of,
    mfcc_allowance,
)

MFCC_RTOL, MFCC_ATOL = 2e-3, 3e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel tests run on the card)")
    return torch.device("cuda", 0)


def speech_like(rng, n):
    t = np.arange(n) / 16000.0
    return (
        4000 * np.sin(2 * np.pi * 300 * t)
        + 1500 * np.sin(2 * np.pi * 1200 * t)
        + 300 * rng.randn(n)
    ).astype(np.float32)


def random_graph(rng, num_states, extra_arcs, num_pdfs=40, folded=True, hubs=0):
    """Chain + self-loops + random extra arcs (+ optional hub states with
    in-degree num_states/2), pdfs a function of the source when folded;
    two final states, so the final argmin crosses slices."""
    S = num_states
    src = np.concatenate([np.arange(S), np.arange(S), rng.randint(S, size=extra_arcs)])
    dst = np.concatenate([(np.arange(S) + 1) % S, np.arange(S), rng.randint(S, size=extra_arcs)])
    for h in range(hubs):
        hub_src = np.arange(0, S, 2)
        src = np.concatenate([src, hub_src])
        dst = np.concatenate([dst, np.full(hub_src.size, S - 1 - h)])
    A = src.size
    if folded:
        pdf = rng.randint(num_pdfs, size=S)[src]
    else:
        pdf = rng.randint(num_pdfs, size=A)
    init = np.full(S, NEG_INF_F32, np.float32)
    init[0] = 0.0
    final = np.full(S, NEG_INF_F32, np.float32)
    final[S - 1] = 0.25
    final[S // 2] = 0.5
    return DenseGraph(
        num_states=S,
        arc_src=src.astype(np.int32),
        arc_dst=dst.astype(np.int32),
        arc_pdf=pdf.astype(np.int32),
        arc_wseq=np.zeros(A, np.int32),
        arc_weight=rng.rand(A).astype(np.float32),
        final_weight=final,
        final_wseq=np.zeros(S, np.int32),
        init_weight=init,
        init_wseq=np.zeros(S, np.int32),
        word_seqs=[()],
        num_pdfs=num_pdfs,
    )


def assert_decode_bit_exact(dense, device, B=5, T=11, lengths=None, scale=0.7, seed=0,
                            cluster=None, resident=True, plan=None, grid=None):
    """The kernel (through viterbi_decode, or one launch with a forced
    cluster size of the replicated body, or a forced ``plan(graph)`` of any
    body) bit-equal to the plain twin on all five outputs; ``grid`` rounds
    the log-probs to its multiples (ties)."""
    rng = np.random.RandomState(seed)
    lp = rng.randn(B, T, dense.num_pdfs).astype(np.float32)
    if grid is not None:
        lp = (np.round(lp / grid) * grid).astype(np.float32)
    lp = torch.as_tensor(lp, device=device)
    lens = torch.as_tensor(T if lengths is None else lengths, dtype=torch.int32, device=device)
    lens = lens.expand(B).contiguous()
    g = DecodeGraph.from_dense(dense, device)
    compact = dense.num_arcs <= 65533
    want_alpha, want_bps = viterbi(g, lp, scale, lens, compact_bp=compact)
    want = backtrace(g, want_alpha, want_bps)
    before = viterbi_decode.launches
    if plan is not None:
        got = launch(g, plan(g), resident, lp, scale, lens)
    elif cluster is None:
        got = viterbi_decode(g, lp, scale, lens, return_forward=True)
    else:
        got = launch(g, plan_viterbi(g, cluster), resident, lp, scale, lens)
    torch.cuda.synchronize()
    assert viterbi_decode.launches == before + 1
    assert got[4].dtype == want_bps.dtype
    for a, b in zip(got, want + (want_alpha, want_bps)):
        np.testing.assert_array_equal(
            a.cpu().to(torch.int64 if a.dtype == torch.uint16 else a.dtype).numpy(),
            b.cpu().to(torch.int64 if b.dtype == torch.uint16 else b.dtype).numpy(),
        )


@pytest.mark.cuda
@pytest.mark.parametrize(
    "cfg",
    [
        FrontendConfig(),
        FrontendConfig(num_mel_bins=20, num_ceps=20),
        FrontendConfig(use_energy=True),
        FrontendConfig(use_energy=True, raw_energy=False, energy_floor=1.0),
        FrontendConfig(snip_edges=False),
        FrontendConfig(samp_freq=8000.0, num_mel_bins=23, num_ceps=13, high_freq=-200.0),
        FrontendConfig(round_to_power_of_two=False),
        FrontendConfig(samp_freq=8000.0, num_mel_bins=23, num_ceps=13, high_freq=-200.0,
                       round_to_power_of_two=False, use_energy=True),
        FrontendConfig(num_mel_bins=23, num_ceps=13, high_freq=0.0),
        FrontendConfig(num_ceps=26, frame_length_ms=32.0, frame_shift_ms=20.0),
    ],
    ids=["hires", "20x20", "energy_raw", "energy_windowed", "no_snip", "8k_n256", "n400",
         "8k_n200_energy", "tri1_13x23", "coqui_26x40_n512"],
)
def test_mfcc_kernel_matches_plain(cuda, cfg):
    rng = np.random.RandomState(1)
    pcm = torch.as_tensor(np.stack([speech_like(rng, 24000) for _ in range(3)]), device=cuda)
    params = make_frontend_params(cfg, cuda)
    want = mfcc_batch_torch(params, pcm)
    before = mfcc_batch.launches
    got = mfcc_batch(params, pcm)
    torch.cuda.synchronize()
    assert mfcc_batch.launches == before + 1
    assert got.shape == want.shape
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=MFCC_RTOL, atol=MFCC_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind", ["folded", "hubs", "unfolded", "lengths", "int32_bp", "batch1", "ragged_zero",
             "hub_256"]
)
def test_viterbi_kernel_bit_exact(cuda, kind):
    rng = np.random.RandomState(7)
    if kind == "folded":
        assert_decode_bit_exact(random_graph(rng, 37, 120), cuda)
    elif kind == "hubs":
        assert_decode_bit_exact(random_graph(rng, 300, 500, hubs=3), cuda, seed=1)
    elif kind == "unfolded":
        assert_decode_bit_exact(random_graph(rng, 53, 200, folded=False), cuda, seed=2)
    elif kind == "lengths":
        assert_decode_bit_exact(
            random_graph(rng, 41, 90), cuda, B=6, lengths=[11, 0, 4, 7, 1, 11], seed=3
        )
    elif kind == "int32_bp":  # > 65533 arcs: int32 backpointers
        assert_decode_bit_exact(random_graph(rng, 3000, 66000), cuda, B=2, T=6, seed=4)
    elif kind == "batch1":
        assert_decode_bit_exact(random_decode_graph(rng, 5000, 3000, 300), cuda, B=1, T=20, seed=6)
    elif kind == "ragged_zero":
        assert_decode_bit_exact(random_decode_graph(rng, 3000, 2000, 200), cuda, B=7, T=13,
                                lengths=[13, 0, 5, 1, 12, 0, 9], seed=8)
    else:  # hubs of 300 in-arcs: the warp path with ~10 arcs a lane
        assert_decode_bit_exact(random_decode_graph(rng, 2500, 1500, 100, hubs=3, hub_arcs=300),
                                cuda, B=3, T=9, seed=9)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
@pytest.mark.parametrize("resident", [True, False], ids=["smem_tables", "l2_tables"])
def test_viterbi_kernel_every_cluster_size(cuda, cluster, resident):
    """Each cluster size, tables in shared memory and in global memory, on
    a graph whose 8-lane-group states and final states fall in different
    slices."""
    dense = random_decode_graph(np.random.RandomState(13), 4000, 2500, 500, hubs=3, hub_arcs=40)
    assert_decode_bit_exact(dense, cuda, B=4, T=10, lengths=[10, 3, 0, 10], seed=14,
                            cluster=cluster, resident=resident)


def assert_chunked_decode_bit_exact(dense, device, B, cluster=None, resident=True, seed=0,
                                    plan=None):
    """A stream decoded in 7-frame chunks, each one launch that starts from
    the alpha the previous launch returned: alpha and backpointers equal to
    the plain ``viterbi(alpha0=...)`` chunk by chunk, and the final alpha to
    one whole decode."""
    rng = np.random.RandomState(seed)
    T, Tc = 20, 7
    g = DecodeGraph.from_dense(dense, device)
    compact = dense.num_arcs <= 65533
    lp = torch.as_tensor(rng.randn(B, T, dense.num_pdfs).astype(np.float32), device=device)
    lens = torch.as_tensor(rng.randint(0, T + 1, size=B), dtype=torch.int32, device=device)
    lens[0] = T
    whole_alpha, _ = viterbi(g, lp, 0.7, lens, compact_bp=compact)
    alpha = None
    for lo in range(0, T, Tc):
        chunk = lp[:, lo : lo + Tc].contiguous()
        clen = (lens - lo).clamp(0, chunk.shape[1]).contiguous()
        want_alpha, want_bps = viterbi(g, chunk, 0.7, clen, compact_bp=compact, alpha0=alpha)
        want = backtrace(g, want_alpha, want_bps) + (want_alpha, want_bps)
        before = viterbi_decode.launches
        if plan is not None:
            got = launch(g, plan(g), resident, chunk, 0.7, clen, alpha)
        elif cluster is None:
            got = viterbi_decode(g, chunk, 0.7, clen, return_forward=True, alpha0=alpha)
        else:
            got = launch(g, plan_viterbi(g, cluster), resident, chunk, 0.7, clen, alpha)
        torch.cuda.synchronize()
        assert viterbi_decode.launches == before + 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(
                a.cpu().to(torch.int64 if a.dtype == torch.uint16 else a.dtype).numpy(),
                b.cpu().to(torch.int64 if b.dtype == torch.uint16 else b.dtype).numpy(),
            )
        alpha = got[3]
    assert torch.equal(alpha, whole_alpha)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
@pytest.mark.parametrize("resident", [True, False], ids=["smem_tables", "l2_tables"])
def test_viterbi_kernel_carried_alpha_every_cluster_size(cuda, cluster, resident):
    dense = random_decode_graph(np.random.RandomState(13), 4000, 2500, 500, hubs=3, hub_arcs=40)
    assert_chunked_decode_bit_exact(dense, cuda, B=4, cluster=cluster, resident=resident, seed=21)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["folded_b1", "unfolded", "int32_bp", "deployment_b1",
                                  "deployment_b32"])
def test_viterbi_kernel_carried_alpha(cuda, kind):
    """``viterbi_decode(alpha0=...)`` as the streaming transcriber calls it
    (B = 1, T = 7) and batched, on folded and unfolded graphs and with
    int32 backpointers."""
    rng = np.random.RandomState(17)
    if kind == "folded_b1":
        assert_chunked_decode_bit_exact(random_graph(rng, 300, 500, hubs=2), cuda, B=1, seed=22)
    elif kind == "unfolded":
        assert_chunked_decode_bit_exact(random_graph(rng, 53, 200, folded=False), cuda, B=3,
                                        seed=23)
    elif kind == "int32_bp":
        assert_chunked_decode_bit_exact(random_graph(rng, 3000, 66000), cuda, B=2, seed=24)
    else:
        assert_chunked_decode_bit_exact(random_decode_graph(rng), cuda,
                                        B=1 if kind == "deployment_b1" else 32, seed=25)


@pytest.mark.cuda
def test_viterbi_kernel_rejects_bad_carried_alpha(cuda):
    g = DecodeGraph.from_dense(random_graph(np.random.RandomState(18), 37, 120), cuda)
    lp = torch.zeros((2, 3, 40), device=cuda)
    with pytest.raises(ValueError, match="alpha0"):
        viterbi_decode(g, lp, alpha0=torch.zeros((1, 37), device=cuda))
    with pytest.raises(ValueError, match="alpha0"):
        viterbi_decode(g, lp, alpha0=torch.zeros((2, 37), dtype=torch.float64, device=cuda))


@pytest.mark.cuda
def test_viterbi_kernel_deployment_size_batch32(cuda):
    """14,200 states / 38,400 arcs at the main path's batch: C = 4, tables
    resident (113.6 KB of alpha + the slice's tables)."""
    dense = random_decode_graph(np.random.RandomState(15))
    g = DecodeGraph.from_dense(dense, cuda)
    assert smem_layout(g.num_states, plan_viterbi(g, 4), True, True)[1] <= 227 * 1024
    assert_decode_bit_exact(dense, cuda, B=32, T=40, seed=16)


@pytest.mark.cuda
def test_mfcc_kernel_main_path_shape_and_window_limit(cuda):
    """[32, 48000] as the main path frames it; an odd window (401 samples,
    Bluestein's algorithm in the kernel) against its twin too."""
    rng = np.random.RandomState(2)
    pcm = torch.as_tensor(np.stack([speech_like(rng, 48000) for _ in range(32)]), device=cuda)
    params = make_frontend_params(FrontendConfig(), cuda)
    got = mfcc_batch(params, pcm)
    want = mfcc_batch_torch(params, pcm)
    assert got.shape == (32, 298, 40)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=MFCC_RTOL, atol=MFCC_ATOL)
    odd = FrontendConfig(frame_length_ms=25.0625, round_to_power_of_two=False)
    assert odd.padded_window_size == 401
    odd_params = make_frontend_params(odd, cuda)
    got = mfcc_batch(odd_params, pcm)
    want = mfcc_batch_torch(odd_params, pcm)
    assert got.shape == (32, 298, 40)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=MFCC_RTOL, atol=MFCC_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [FrontendConfig(), FrontendConfig(frame_length_ms=25.0625,
                                                                  round_to_power_of_two=False)],
                         ids=["n512", "n401_bluestein"])
def test_mfcc_kernel_within_float64_allowance(cuda, cfg):
    """Both K1 bodies against float64 on speech-like bursts and their clean
    tones at gains over 4 decades (tests/test_torch_feature_tolerance.py:
    frames up to 10^10 above their weakest mel band) and on the main path's
    seeded noise."""
    from test_torch_feature_tolerance import bursts

    family = bursts()
    noise = (1000.0 * np.random.RandomState(0).randn(2, family.shape[0])).astype(np.float32)
    pcm = np.concatenate([family[None], noise])
    got = mfcc_batch(make_frontend_params(cfg, cuda), torch.as_tensor(pcm, device=cuda))
    want = np.stack([mfcc_numpy(cfg, x) for x in pcm])
    assert_mfcc_close(got, want, mfcc_allowance(cfg, frames_of(cfg, pcm)), "K1 against float64")


@pytest.mark.cuda
def test_viterbi_kernel_large_graph_shared_memory(cuda):
    """~14k states: alpha needs > 48 KB of dynamic shared memory."""
    rng = np.random.RandomState(11)
    assert_decode_bit_exact(
        random_graph(rng, 14200, 9600, num_pdfs=3072, hubs=2), cuda, B=3, T=8, seed=5
    )


@pytest.mark.cuda
def test_viterbi_kernel_rejects_oversized_graph(cuda):
    """Past the replicated body's shared memory (40,000 states) the kernel
    no longer refuses: ``viterbi_decode`` takes the halo body, bit-equal to
    the plain twin at B = 1 and B = 32."""
    rng = np.random.RandomState(12)
    dense = random_graph(rng, 40000, 10)
    assert not alpha_fits(40000, H100_MAX_SMEM)
    g = DecodeGraph.from_dense(dense, cuda)
    for B in (1, 32):
        assert select_plan(g, B)[0].body == "halo"
        before = dict(viterbi_decode.body_launches)
        assert_decode_bit_exact(dense, cuda, B=B, T=12, seed=B)
        assert viterbi_decode.body_launches["halo"] == before["halo"] + 1


def card_runs(g, plan, resident):
    return max_clusters(g, plan, resident) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", LARGE_CLUSTER_SIZES)
@pytest.mark.parametrize("resident", [True, False], ids=["smem_tables", "l2_tables"])
def test_viterbi_halo_body_every_cluster_size(cuda, cluster, resident):
    """The halo body forced at each cluster size (16 where the card runs
    it), tables in shared and in global memory, on a graph whose group and
    hub states and final states fall in different slices."""
    dense = random_decode_graph(np.random.RandomState(13), 4000, 2500, 500, hubs=3, hub_arcs=40)
    g = DecodeGraph.from_dense(dense, cuda)
    if not card_runs(g, plan_halo(g, cluster), resident):
        pytest.skip(f"the card runs no cluster of {cluster} CTAs of this shape")
    assert_decode_bit_exact(dense, cuda, B=4, T=10, lengths=[10, 3, 0, 10], seed=14,
                            resident=resident, plan=lambda g: plan_halo(g, cluster))


def edge_tie_graph(cluster):
    """A 600-state graph with costs on a coarse grid (weights in quarters;
    states of 40 and 300 in-arcs) whose states on either side of the first
    slice edge of a ``cluster``-CTA cut both start and end at cost 0: a
    stream of no frames ties them across the edge, and the lower state must
    win."""
    from test_torch_viterbi_plan import hubby_graph

    dense = hubby_graph(5, num_states=600, extra_arcs=1500)
    bounds = plan_global(DecodeGraph.from_dense(dense, "cpu"), cluster).slice_state.numpy()
    edge = int(bounds[np.flatnonzero((bounds > 0) & (bounds < 600))[0]])
    dense.init_weight[[edge - 1, edge]] = 0.0
    dense.final_weight[[edge - 1, edge]] = 0.0
    return dense, edge


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["halo", "global"])
@pytest.mark.parametrize("cluster", LARGE_CLUSTER_SIZES)
def test_viterbi_large_bodies_on_ties(cuda, body, cluster):
    """Both large bodies on costs on a coarse grid: ties within a state's
    in-arcs, across a group's or a warp's lanes and between final states on
    either side of a slice edge go as the twin takes them."""
    dense, _edge = edge_tie_graph(cluster)
    make = plan_halo if body == "halo" else plan_global
    g = DecodeGraph.from_dense(dense, cuda)
    if not card_runs(g, make(g, cluster), body == "halo"):
        pytest.skip(f"the card runs no cluster of {cluster} CTAs of this shape")
    assert_decode_bit_exact(dense, cuda, B=3, T=9, lengths=[9, 0, 5], scale=0.5, seed=29,
                            resident=body == "halo", plan=lambda g: make(g, cluster), grid=0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int32_bp", "unfolded"])
@pytest.mark.parametrize("cluster", [4, 16])
def test_viterbi_halo_body_int32_and_unfolded(cuda, kind, cluster):
    """The halo body forced on int32 backpointers (arc ids read from the
    CSR, not the packed word) and on an unfolded graph (the per-arc am
    term), tables resident."""
    rng = np.random.RandomState(27)
    dense = {"int32_bp": lambda: random_graph(rng, 3000, 66000, hubs=1),
             "unfolded": lambda: random_graph(rng, 700, 900, folded=False, hubs=2)}[kind]()
    g = DecodeGraph.from_dense(dense, cuda)
    if not card_runs(g, plan_halo(g, cluster), True):
        pytest.skip(f"the card runs no cluster of {cluster} CTAs of this shape")
    assert_decode_bit_exact(dense, cuda, B=3, T=9, lengths=[9, 4, 0], seed=28,
                            plan=lambda g: plan_halo(g, cluster))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["compact", "int32_bp", "unfolded"])
@pytest.mark.parametrize("cluster", [2, 8, 16])
def test_viterbi_global_body(cuda, kind, cluster):
    """The global body at a plan that forces it, bit-equal to the twin, on
    compact and int32 backpointers and an unfolded graph."""
    rng = np.random.RandomState(19)
    dense = {"compact": lambda: random_decode_graph(rng, 4000, 2500, 500, hubs=3, hub_arcs=40),
             "int32_bp": lambda: random_graph(rng, 3000, 66000, hubs=1),
             "unfolded": lambda: random_graph(rng, 700, 900, folded=False, hubs=2)}[kind]()
    g = DecodeGraph.from_dense(dense, cuda)
    if not card_runs(g, plan_global(g, cluster), False):
        pytest.skip(f"the card runs no cluster of {cluster} CTAs of this shape")
    before = viterbi_decode.body_launches["global"]
    assert_decode_bit_exact(dense, cuda, B=3, T=9, lengths=[9, 4, 0], seed=20, resident=False,
                            plan=lambda g: plan_global(g, cluster))
    assert viterbi_decode.body_launches["global"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["halo", "global"])
def test_viterbi_large_bodies_carried_alpha_chunk(cuda, body):
    """A T = 7 chunk with ``alpha0``, as the stream and the scheduler launch
    it, through the halo and the global body on 40,000 states."""
    dense = random_decode_graph(np.random.RandomState(23), 40000, num_pdfs=500)
    plan, res = select_plan(DecodeGraph.from_dense(dense, cuda), 4)
    assert plan.body == "halo"
    if body == "global":
        res = False
    assert_chunked_decode_bit_exact(
        dense, cuda, B=4, seed=26, resident=res,
        plan=lambda g: select_plan(g, 4)[0] if body == "halo" else plan_global(g, 8))


@pytest.mark.cuda
def test_viterbi_checkpointed_launches_the_kernel(cuda):
    """The checkpointed route on the card: two launches a segment (forward,
    then the recompute), bit-equal to the dense decode."""
    dense = random_decode_graph(np.random.RandomState(24), 40000, num_pdfs=500)
    g = DecodeGraph.from_dense(dense, cuda)
    rng = np.random.RandomState(25)
    lp = torch.as_tensor(rng.randn(3, 37, 500).astype(np.float32), device=cuda)
    lens = torch.as_tensor([37, 20, 0], dtype=torch.int32, device=cuda)
    want = [x.cpu().numpy() for x in viterbi_decode(g, lp, 0.8, lens)]
    before = viterbi_decode.launches
    got = viterbi_decode_checkpointed(g, lp, 0.8, segment=16, lengths=lens)
    assert viterbi_decode.launches == before + 2 * 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def assert_relax_bit_exact(tables, T, B, s_pad, device, alpha0=None, cluster=None):
    """The kernel (through windowed_relax, or one launch with a forced
    cluster size) bit-equal to the plain version."""
    tables = [torch.as_tensor(x, device=device) for x in tables]
    a0 = None if alpha0 is None else torch.as_tensor(alpha0, device=device)
    want = windowed_relax_torch(*tables, T, B, s_pad, alpha0=a0)
    before = windowed_relax.launches
    steps = prepare_steps(*tables, s_pad)
    if cluster is None:
        got = windowed_relax(steps, T, B, alpha0=a0)
    else:
        got = windowed_relax_cuda.launch(steps, T, B, a0, cluster)
    torch.cuda.synchronize()
    assert windowed_relax.launches == before + 1
    assert got[1].dtype == torch.uint16
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    np.testing.assert_array_equal(got[1].cpu().to(torch.int32).numpy(),
                                  want[1].cpu().to(torch.int32).numpy())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("s_pad,nstep", [(256, 8), (1024, 100), (14208, 1280)])
def test_windowed_relax_kernel_bit_exact(cuda, s_pad, nstep):
    """The example's shared tables; 14,208 states need 113 KB of shared
    memory."""
    assert_relax_bit_exact(make_step_tables(nstep, s_pad), 3, 4, s_pad, cuda)


@pytest.mark.cuda
def test_windowed_relax_kernel_per_stream(cuda):
    """Tables and initial alpha differ per stream, with many exact ties: a
    kernel that reads another stream's row cannot pass."""
    B, s_pad, nstep = 5, 512, 60
    rng = np.random.RandomState(9)
    per = [make_step_tables(nstep, s_pad, seed=40 + i) for i in range(B)]
    dbase, sbase, idx, w, arc = (np.stack(x) for x in zip(*per))
    w = (np.round(w * 4) / 4).astype(np.float32)
    arc = (arc % 11).astype(np.int32)
    alpha0 = (np.round(rng.rand(B, s_pad) * 8) / 8).astype(np.float32)
    _, bp = assert_relax_bit_exact((dbase, sbase, idx, w, arc), 4, B, s_pad, cuda, alpha0)
    assert not torch.equal(bp[:, 0], bp[:, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", windowed_relax_cuda.CLUSTER_SIZES)
@pytest.mark.parametrize("s_pad,nstep,B", [(1024, 100, 13), (14208, 300, 5)])
def test_windowed_relax_kernel_every_cluster_size(cuda, cluster, s_pad, nstep, B):
    """Each cluster size at a batch that is no multiple of it (the last
    cluster has CTAs without a stream), with initial alphas that differ per
    stream, many exact ties and a ring that wraps many times a frame."""
    dbase, sbase, idx, w, arc = make_step_tables(nstep, s_pad, seed=3)
    w = (np.round(w * 4) / 4).astype(np.float32)
    arc = (arc % 300).astype(np.int32)
    alpha0 = (np.round(np.random.RandomState(4).rand(B, s_pad) * 8) / 8).astype(np.float32)
    _, bp = assert_relax_bit_exact((dbase, sbase, idx, w, arc), 5, B, s_pad, cuda, alpha0,
                                   cluster=cluster)
    assert not torch.equal(bp[:, 0], bp[:, B - 1])


@pytest.mark.cuda
def test_windowed_relax_kernel_refuses_what_it_cannot_run(cuda):
    """Per-stream tables in a cluster, and an s_pad whose alpha leaves no
    room for the ring: errors, not another path."""
    per = [make_step_tables(10, 256, seed=i) for i in range(2)]
    steps = prepare_steps(*(torch.as_tensor(np.stack(x), device=cuda) for x in zip(*per)), 256)
    with pytest.raises(ValueError, match="cluster size"):
        windowed_relax_cuda.launch(steps, 2, 2, None, 2)
    big = prepare_steps(*(torch.as_tensor(x, device=cuda) for x in make_step_tables(10, 16768)),
                        16768)
    with pytest.raises(ValueError, match="shared memory"):
        windowed_relax(big, 2, 2)
