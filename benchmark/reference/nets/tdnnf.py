"""A Kaldi chain TDNN-F as the ``tdnnf-layer`` xconfig builds it (Povey et
al., "Semi-orthogonal low-rank matrix factorization for deep neural
networks", 2018; ``steps/libs/nnet3/xconfig/composite_layers.py``):

- ``lda``: a fixed affine over the input at ``lda_offsets`` and the
  i-vector;
- ``tdnn1``: affine, relu, batch norm (``relu-batchnorm-dropout-layer``;
  the dropout is the identity at test time);
- one ``tdnnf-layer`` a stride ``s`` of ``time_strides``: a linear
  bottleneck over ``(t - s, t)``, an affine over ``(t, t + s)`` (both over
  ``t`` alone where ``s`` is 0), relu, batch norm, and the bypass
  ``bypass_scale`` times the layer's input added;
- ``prefinal-l``: a linear component; ``prefinal-chain``
  (``prefinal-layer``): affine, relu, batch norm, linear, batch norm;
- ``output``: an affine (no log-softmax in a chain model).

The cross-entropy branch (``prefinal-xent``, ``output-xent``) is in the
model file but no decoder reads it, so the reference leaves it out; its
weights are drawn after all others.

The weights are drawn here from the seed (``draw``), and the benchmark's
writer (``benchmark/models/tdnnf.py``) puts the same arrays in the model
file: the benchmark makes them and hands them to both sides.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import weights as W
from benchmark.reference.nets import SUBSAMPLING, affine, bn, splice, t, with_ivector

# the family at CPU size, for the benchmark's tests: the recipe's layout
# (``configs/tdnnf-minilibri1h-grammar13789.json``) at narrow widths
TINY_ARGS = {"num_ceps": 40, "ivector_dim": 8, "ubm_gauss": 8, "num_pdfs": 400,
             "lda_offsets": [-1, 0, 1], "tdnn1_dim": 32, "tdnnf_dim": 32, "bottleneck_dim": 8,
             "time_strides": [1, 1, 1, 0, 3, 3, 3, 3, 3, 3, 3, 3], "bypass_scale": 0.66,
             "prefinal_l_dim": 12, "prefinal_big_dim": 32, "prefinal_small_dim": 12}


def layer_offsets(stride: int) -> Tuple[Sequence[int], Sequence[int]]:
    """The time offsets of a TDNN-F layer's linear and affine parts."""
    return ((-stride, 0), (0, stride)) if stride else ((0,), (0,))


def draw(args: Dict, seed: int, xent: bool = False) -> Dict:
    """The network's parameters as stored: float32 matrices and biases, and
    each batch norm's stored (mean, var)."""
    rng = np.random.RandomState(seed)
    C, K, offs = args["num_ceps"], args["ivector_dim"], args["lda_offsets"]
    lda_dim = len(offs) * C + K
    D, F, Bn = args["tdnn1_dim"], args["tdnnf_dim"], args["bottleneck_dim"]
    L, big, small = args["prefinal_l_dim"], args["prefinal_big_dim"], args["prefinal_small_dim"]
    net: Dict = {"lda": (W.lda(rng, lda_dim), np.zeros(lda_dim, np.float32)),
                 "tdnn1": W.affine(rng, lda_dim, D), "tdnn1.bn": W.batchnorm_stats(rng, D)}
    layers: List[Dict] = []
    prev = D
    for s in args["time_strides"]:
        lin_offs, aff_offs = layer_offsets(s)
        lin, _ = W.tdnn(rng, prev, Bn, len(lin_offs), bias=False)
        layers.append({"stride": s, "linear": lin,
                       "affine": W.tdnn(rng, Bn, F, len(aff_offs), bias=True),
                       "bn": W.batchnorm_stats(rng, F)})
        prev = F
    net["layers"] = layers
    net["prefinal-l"] = W.affine(rng, prev, L)[0]

    def prefinal():
        return {"affine": W.affine(rng, L, big), "bn1": W.batchnorm_stats(rng, big),
                "linear": W.affine(rng, big, small)[0], "bn2": W.batchnorm_stats(rng, small)}

    net["prefinal-chain"] = prefinal()
    net["output"] = W.affine(rng, small, args["num_pdfs"])
    if xent:
        net["prefinal-xent"] = prefinal()
        net["output-xent"] = W.affine(rng, small, args["num_pdfs"])
    return net


def weights(args: Dict, seed: int) -> Dict:
    net = draw(args, seed)
    net.update(lda_offsets=tuple(args["lda_offsets"]), bypass_scale=float(args["bypass_scale"]))
    return net


def context(args: Dict) -> Tuple[int, int]:
    """Input frames of left and of right context an output frame reads."""
    span = sum(int(s) for s in args["time_strides"])
    return span - min(args["lda_offsets"]), span + max(args["lda_offsets"])


def window(args: Dict, n_out: int) -> Tuple[int, int]:
    left, right = context(args)
    return -left, SUBSAMPLING * (n_out - 1) + right + 1


def zero_state(net: Dict, B: int, like: torch.Tensor):
    return None


def forward(net: Dict, x: torch.Tensor, ivec: torch.Tensor, state, n_out: int):
    """Outputs [B, n_out, P] from the input frames of ``window``."""
    h = affine(with_ivector(splice(x, net["lda_offsets"]), ivec), net["lda"])
    h = bn(torch.relu(affine(h, net["tdnn1"])), W.scale_offset(*net["tdnn1.bn"]))
    for layer in net["layers"]:
        s = layer["stride"]
        lin_offs, aff_offs = layer_offsets(s)
        y = splice(h, lin_offs) @ t(layer["linear"], h).T
        y = affine(splice(y, aff_offs), layer["affine"])
        y = bn(torch.relu(y), W.scale_offset(*layer["bn"]))
        h = net["bypass_scale"] * h[:, s: s + y.shape[1]] + y
    h = h @ t(net["prefinal-l"], h).T
    p = net["prefinal-chain"]
    h = bn(torch.relu(affine(h, p["affine"])), W.scale_offset(*p["bn1"]))
    h = bn(h @ t(p["linear"], h).T, W.scale_offset(*p["bn2"]))
    return affine(h, net["output"])[:, ::SUBSAMPLING][:, :n_out], None


def products(args: Dict) -> List:
    """The matrix products a decode runs, in order (the cross-entropy branch
    is not run)."""
    C, K, offs = args["num_ceps"], args["ivector_dim"], tuple(args["lda_offsets"])
    lda_dim = len(offs) * C + K
    D, F, Bn = args["tdnn1_dim"], args["tdnnf_dim"], args["bottleneck_dim"]
    L, big, small = args["prefinal_l_dim"], args["prefinal_big_dim"], args["prefinal_small_dim"]
    out = [("lda", lda_dim, lda_dim, offs), ("tdnn1", lda_dim, D, (0,))]
    prev = D
    for i, s in enumerate(args["time_strides"], start=2):
        lin_offs, aff_offs = layer_offsets(s)
        out += [(f"tdnnf{i}.linear", len(lin_offs) * prev, Bn, lin_offs),
                (f"tdnnf{i}.affine", len(aff_offs) * Bn, F, aff_offs)]
        prev = F
    return out + [("prefinal-l", prev, L, (0,)), ("prefinal-chain.affine", L, big, (0,)),
                  ("prefinal-chain.linear", big, small, (0,)),
                  ("output", small, args["num_pdfs"], (0,))]
