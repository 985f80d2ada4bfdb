"""K3, the windowed relaxation of ``examples/pallas_windowed_cost.py``,
against the port's plain version ``windowed_relax_torch``: bit for bit.

The example's Pallas kernel runs here in interpret mode at a small shape.
Nothing in ``examples/`` is edited: the file is loaded under its own
``sys.argv``, its shape globals are set small, ``pl.pallas_call`` gets
``interpret=True`` and ``jax.block_until_ready`` hands over the first
output and stops ``main()`` before its timing loop.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

import torch

from rhasspy_speech_torch.examples import windowed_cost
from rhasspy_speech_torch.ops.windowed_relax_cuda import (
    group_by_destination,
    prepare_steps,
    windowed_relax,
    windowed_relax_torch,
)

REPO = Path(__file__).resolve().parent.parent


class _Captured(Exception):
    pass


def run_pallas_example(monkeypatch, s_pad, p, t, b, nstep, bt):
    """alpha [B, S_pad] f32 and bp [T, B, S_pad] uint16 of the example's
    Pallas kernel in interpret mode."""
    monkeypatch.setattr(sys, "argv", ["pallas_windowed_cost.py", str(nstep), str(bt)])
    spec = importlib.util.spec_from_file_location(
        "pallas_windowed_cost_under_test", REPO / "examples" / "pallas_windowed_cost.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.S_pad, mod.P, mod.T, mod.B = s_pad, p, t, b
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(mod.pl.pallas_call, interpret=True))
    got = []

    def capture(out):
        got.append(jax.device_get(out))
        raise _Captured

    monkeypatch.setattr(mod.jax, "block_until_ready", capture)
    with pytest.raises(_Captured):
        mod.main()
    alpha, bp = got[0]
    return np.asarray(alpha), np.asarray(bp)


@pytest.mark.parametrize("s_pad,t,b,nstep,bt", [(256, 3, 8, 8, 4), (384, 4, 4, 24, 2)])
def test_plain_equals_pallas_interpret(monkeypatch, s_pad, t, b, nstep, bt):
    want_alpha, want_bp = run_pallas_example(monkeypatch, s_pad, 16, t, b, nstep, bt)
    tables = [torch.as_tensor(x) for x in windowed_cost.make_step_tables(nstep, s_pad)]
    alpha, bp = windowed_relax_torch(*tables, t, b, s_pad)
    assert want_alpha.shape == (b, s_pad) and want_bp.shape == (t, b, s_pad)
    assert alpha.dtype == torch.float32 and bp.dtype == torch.uint16
    np.testing.assert_array_equal(alpha.numpy(), want_alpha)
    np.testing.assert_array_equal(bp.to(torch.int32).numpy(), want_bp.astype(np.int32))


def _sequential(tables, t, b, s_pad, alpha0):
    """The TPU kernel's loop, step by step in NumPy, stream by stream (each
    stream may have tables of its own)."""
    alpha = alpha0.astype(np.float32).copy()
    bps = np.zeros((t, b, s_pad), np.uint16)
    lanes = np.arange(128)
    for f in range(t):
        for s in range(b):
            db, sb, ix, ww, aa = (x[s] if tables[0].ndim == 2 else x for x in tables)
            bc = alpha[s] + np.float32(0.5)
            bi = np.zeros(s_pad, np.int32)
            for i in range(db.shape[0]):
                d = db[i] + lanes
                c = alpha[s][sb[i] + ix[i]] + ww[i]
                take = (c < bc[d]) | ((c == bc[d]) & (aa[i] < bi[d]))
                bc[d] = np.where(take, c, bc[d])
                bi[d] = np.where(take, aa[i], bi[d])
            alpha[s] = bc  # stream s reads only its own row
            bps[f, s] = bi.astype(np.uint16)
    return alpha, bps


def _per_stream_case(seed, b=3, nstep=10, s_pad=256, ties=False):
    """Tables and initial alpha that differ per stream; with ``ties``,
    quantised weights and few arc ids give many exact cost ties."""
    rng = np.random.RandomState(seed)
    per = [windowed_cost.make_step_tables(nstep, s_pad, seed=seed * 10 + i) for i in range(b)]
    dbase, sbase, idx, w, arc = (np.stack(x) for x in zip(*per))
    if ties:
        w = (np.round(w * 4) / 4).astype(np.float32)
        arc = (arc % 7).astype(np.int32)
    alpha0 = (rng.rand(b, s_pad) * (0.0 if ties else 3.0)).astype(np.float32)
    return (dbase, sbase, idx, w, arc), alpha0


@pytest.mark.parametrize("ties", [False, True])
def test_plain_equals_sequential_per_stream(ties):
    tables, alpha0 = _per_stream_case(3, ties=ties)
    want_alpha, want_bp = _sequential(tables, 3, 3, 256, alpha0)
    alpha, bp = windowed_relax_torch(*(torch.as_tensor(x) for x in tables), 3, 3, 256,
                                     alpha0=torch.as_tensor(alpha0))
    np.testing.assert_array_equal(alpha.numpy(), want_alpha)
    np.testing.assert_array_equal(bp.to(torch.int32).numpy(), want_bp.astype(np.int32))
    # streams really differ, so a kernel that mixes them up cannot pass
    assert not np.array_equal(want_bp[:, 0], want_bp[:, 1])


def test_plain_invariant_under_step_permutation():
    """The merge is a lexicographic minimum: any order of the steps (the
    kernel's regrouping by destination block included) gives the same
    bits."""
    tables, alpha0 = _per_stream_case(5, b=2, nstep=40, ties=True)
    tables = tuple(x[0] for x in tables)  # shared tables
    ref = windowed_relax_torch(*(torch.as_tensor(x) for x in tables), 4, 2, 256,
                               alpha0=torch.as_tensor(alpha0))
    perm = np.random.RandomState(0).permutation(40)
    permuted = [torch.as_tensor(x[perm]) for x in tables]
    got = windowed_relax_torch(*permuted, 4, 2, 256, alpha0=torch.as_tensor(alpha0))
    _, sb, ix, wg, ag = group_by_destination(*(torch.as_tensor(x) for x in tables), 256)
    order = np.argsort(tables[0], kind="stable")
    np.testing.assert_array_equal(sb[0].numpy(), tables[1][order])
    grouped = [torch.as_tensor(tables[0][order]), sb[0], ix[0], wg[0], ag[0]]
    via_groups = windowed_relax_torch(*grouped, 4, 2, 256, alpha0=torch.as_tensor(alpha0))
    for other in (got, via_groups):
        np.testing.assert_array_equal(other[0].numpy(), ref[0].numpy())
        np.testing.assert_array_equal(other[1].numpy(), ref[1].numpy())


def test_group_by_destination_block_pointers():
    tables, _ = _per_stream_case(7, b=2, nstep=30)
    blk_ptr, *_ = group_by_destination(*(torch.as_tensor(x) for x in tables), 256)
    for s in range(2):
        counts = np.bincount(tables[0][s] // 128, minlength=2)
        np.testing.assert_array_equal(blk_ptr[s].numpy(), np.concatenate([[0], np.cumsum(counts)]))


def test_wrapper_runs_plain_version_on_cpu():
    tables = [torch.as_tensor(x) for x in windowed_cost.make_step_tables(6, 256)]
    steps = prepare_steps(*tables, 256)
    assert all(a is b for a, b in zip(steps.tables, tables))
    before = windowed_relax.launches
    got = windowed_relax(steps, 2, 3)
    assert windowed_relax.launches == before
    want = windowed_relax_torch(*tables, 2, 3, 256)
    for a, b in zip(got, want):
        assert torch.equal(a.to(torch.float32), b.to(torch.float32))
    # every stream equal on the example's shared tables, all computed
    assert torch.equal(got[1][:, 0], got[1][:, 2])


@pytest.mark.parametrize("which,value,match", [
    ("dbase", 1, "multiples of 128"),
    ("sbase", 256, "below s_pad"),
    ("idx", 128, r"\[0, 128\)"),
    ("arc", -1, r"arc in \[0, 33554432\)"),
    ("arc", 1 << 25, r"arc in \[0, 33554432\)"),
    ("w", None, "must be"),
])
def test_prepare_steps_rejects_bad_tables(which, value, match):
    """Tables are checked once, before any launch: block bases off the
    128 grid or past s_pad, lane indices past 128, arc ids that do not fit
    the 25 bits beside a lane index, and shapes that do not match."""
    tables = dict(zip(("dbase", "sbase", "idx", "w", "arc"),
                      (torch.as_tensor(x) for x in windowed_cost.make_step_tables(4, 256))))
    if value is None:
        tables[which] = tables[which][:, :64]
    else:
        tables[which] = tables[which].clone()
        tables[which].view(-1)[0] = value
    with pytest.raises(ValueError, match=match):
        prepare_steps(*tables.values(), 256)
