"""The acoustic models' forward passes in float64 PyTorch, one module a model
family (``reference/nets/<family>.py``), found by the configuration's
``model.family``. Each module gives:

- ``weights(args, seed)``: the network's parameters, drawn from the seed as
  the model directory's writer draws them (``benchmark/models/<family>.py``);
- ``window(args, n_out)``: the input frames ``[lo, hi)``, relative to the
  first output frame, that ``n_out`` output frames read; the context is
  worked out from the layers' time offsets;
- ``zero_state(net, B, like)`` and ``forward(net, x, ivec, state, n_out)``:
  the outputs at ``n_out`` output frames (subsampling 3) from the input
  frames ``x`` [B, hi - lo, C] of that window and the i-vector [B, K] at
  every frame, and the recurrent state carried past them (None for a
  feed-forward net);
- ``products(args)``: the matrix products in order, (name, in_dim,
  out_dim, time offsets of its input), for ``counts/roofline.py``;
- ``TINY_ARGS``: a whole ``model.args`` in the family's layout at CPU size,
  every key that these functions and the family's writer read; the tests
  run each family's cells at this size, taking from it each key that a
  configuration's arguments hold (``benchmark/tests/conftest.py:shrink``).

A model family joins the benchmark as two new files, this module and its
writer (``benchmark/models/<family>.py``), with a configuration that names
it: no other file of the benchmark names a family.

Batch norm runs in test mode: ``(x - mean) * target_rms / sqrt(var + eps)``.
A ``TdnnComponent`` over time offsets ``(a, b)`` is one product over the
two frames' rows side by side. Every node is computed at every frame of the
window with "valid" splices (each splice shortens the window by its span),
and the outputs are read at the output frames: the values are those of
computing only the frames a plan needs.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Sequence

import torch

SUBSAMPLING = 3


def load(family: str) -> ModuleType:
    return importlib.import_module(f"{__name__}.{family}")


def t(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device).to(like.dtype)


def splice(x: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """[B, n, d] -> [B, n - span, d * len(offsets)]: row i holds the rows at
    time ``i - min(offsets) + o`` for each offset ``o``."""
    lo, n = min(offsets), x.shape[1] - (max(offsets) - min(offsets))
    return torch.cat([x[:, o - lo: o - lo + n] for o in offsets], dim=-1)


def affine(x, wb):
    w, b = wb
    y = x @ t(w, x).T
    return y if b is None else y + t(b, x)


def bn(x, sb):
    return x * t(sb[0], x) + t(sb[1], x)


def with_ivector(x: torch.Tensor, ivec: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, ivec[:, None, :].expand(-1, x.shape[1], -1)], dim=-1)
