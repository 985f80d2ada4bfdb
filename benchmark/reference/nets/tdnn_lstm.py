"""A Kaldi chain TDNN-LSTM in the layout of the port's writer
(``rhasspy_speech_torch/testing/full_width.py:build_tdnn_lstm_spec``): an
lda over the input at ``(t-2 .. t+2)`` and the i-vector; relu-batchnorm
``tdnn1``, ``tdnn2`` and ``tdnn3`` (the last two over ``(t-1, t, t+1)``);
then three ``fast-lstmp-layer``s (delay -3) with two relu-batchnorm TDNN
layers between each pair, whose splices are three copies of time 0, and the
output affine over ``lstm3`` with no output delay.

``LstmNonlinearityComponent`` takes the gate inputs ``(i, f, g, o)`` and
``c(t - 3)``: ``i = s(i + w_ic c_prev)``, ``f = s(f + w_fc c_prev)``,
``c = f c_prev + i tanh(g)``, ``o = s(o + w_oc c)``, ``m = o tanh(c)``;
``W_rp`` projects ``m`` to the recurrent ``r`` (the first ``proj_dim``)
and the layer's output (all of it). A recurrence read before the stream's
first step is zero, as Kaldi zero-initialises it. The recurrence steps on
the output grid, one step an output frame.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference import weights as W
from benchmark.reference.nets import SUBSAMPLING, affine, bn, splice, with_ivector

# the time offsets of the input splices before the recurrence: lda, tdnn2, tdnn3
TDNN_SPLICES = ((-2, -1, 0, 1, 2), (-1, 0, 1), (-1, 0, 1))
MID_SPLICE = 3  # copies of time 0 that tdnn4-7 splice
# the family at CPU size, for the benchmark's tests
TINY_ARGS = {"num_ceps": 40, "ivector_dim": 8, "ubm_gauss": 8, "num_pdfs": 400,
             "hidden_dim": 32, "cell_dim": 32, "proj_dim": 8}


def weights(args: Dict, seed: int) -> Dict:
    """``build_tdnn_lstm_spec``'s draws, in its order: lda, tdnn1-3, then
    lstm1 and each pair of TDNN layers with the LSTMP layer after it
    (``W_all`` over (input, r(t-3)), the peepholes, ``W_rp``), the
    output."""
    rng = np.random.RandomState(seed)
    C, K = args["num_ceps"], args["ivector_dim"]
    H, cell, P = args["hidden_dim"], args["cell_dim"], args["proj_dim"]
    lda_dim = len(TDNN_SPLICES[0]) * C + K
    net: Dict = {"lda": (W.lda(rng, lda_dim), np.zeros(lda_dim, np.float32))}

    def relu_bn(in_dim):
        w, b = W.affine(rng, in_dim, H)
        return {"affine": (w, b), "bn": W.batchnorm(rng, H)}

    def lstmp():
        w_all = W.affine(rng, H + P, 4 * cell)
        peep = (0.1 * rng.randn(3, cell)).astype(np.float32)
        return {"W_all": w_all, "peep": peep, "W_rp": W.affine(rng, cell, 2 * P)}

    net["tdnn1"] = relu_bn(lda_dim)
    net["tdnn2"] = relu_bn(len(TDNN_SPLICES[1]) * H)
    net["tdnn3"] = relu_bn(len(TDNN_SPLICES[2]) * H)
    net["lstm1"] = lstmp()
    for i, lstm in ((4, "lstm2"), (6, "lstm3")):
        net[f"tdnn{i}"] = relu_bn(MID_SPLICE * 2 * P)
        net[f"tdnn{i + 1}"] = relu_bn(MID_SPLICE * H)
        net[lstm] = lstmp()
    net["output"] = W.affine(rng, 2 * P, args["num_pdfs"])
    net["proj_dim"] = P
    return net


def context(args: Dict) -> Tuple[int, int]:
    return (sum(-min(o) for o in TDNN_SPLICES), sum(max(o) for o in TDNN_SPLICES))


def window(args: Dict, n_out: int) -> Tuple[int, int]:
    left, right = context(args)
    return -left, SUBSAMPLING * (n_out - 1) + right + 1


def _relu_bn(x, layer):
    return bn(torch.relu(affine(x, layer["affine"])), layer["bn"])


def _lstmp(x, layer, state: Tuple[torch.Tensor, torch.Tensor], proj_dim: int):
    """One step: x [B, d], state (c(t-3), r(t-3)) -> (output [B, 2 proj], new state)."""
    c_prev, r_prev = state
    a = affine(torch.cat([x, r_prev], dim=-1), layer["W_all"])
    C = c_prev.shape[-1]
    gi, gf, gg, go = (a[:, k * C:(k + 1) * C] for k in range(4))
    peep = torch.as_tensor(layer["peep"], device=x.device).to(x.dtype)
    i = torch.sigmoid(gi + peep[0] * c_prev)
    f = torch.sigmoid(gf + peep[1] * c_prev)
    c = f * c_prev + i * torch.tanh(gg)
    o = torch.sigmoid(go + peep[2] * c)
    p = affine(o * torch.tanh(c), layer["W_rp"])
    return p, (c, p[:, :proj_dim])


def zero_state(net: Dict, B: int, like: torch.Tensor) -> Dict:
    C = net["lstm1"]["peep"].shape[1]
    P = net["proj_dim"]
    z = like.new_zeros
    return {k: (z((B, C)), z((B, P))) for k in ("lstm1", "lstm2", "lstm3")}


def forward(net: Dict, x: torch.Tensor, ivec: torch.Tensor, state: Dict,
            n_out: int) -> Tuple[torch.Tensor, Dict]:
    """Outputs [B, n_out, P] at output times 0, 3, .. from the input frames
    of ``window``, and the state carried past them."""
    h = affine(with_ivector(splice(x, TDNN_SPLICES[0]), ivec), net["lda"])
    h = _relu_bn(h, net["tdnn1"])
    h = _relu_bn(splice(h, TDNN_SPLICES[1]), net["tdnn2"])
    h = _relu_bn(splice(h, TDNN_SPLICES[2]), net["tdnn3"])  # output times 0 ..
    outs = []
    state = dict(state)
    for m in range(n_out):
        y, state["lstm1"] = _lstmp(h[:, SUBSAMPLING * m], net["lstm1"], state["lstm1"],
                                   net["proj_dim"])
        for i, lstm in ((4, "lstm2"), (6, "lstm3")):
            y = _relu_bn(torch.cat([y] * MID_SPLICE, dim=-1), net[f"tdnn{i}"])
            y = _relu_bn(torch.cat([y] * MID_SPLICE, dim=-1), net[f"tdnn{i + 1}"])
            y, state[lstm] = _lstmp(y, net[lstm], state[lstm], net["proj_dim"])
        outs.append(affine(y, net["output"]))
    return torch.stack(outs, dim=1), state


def products(args: Dict) -> List:
    """The matrix products in order; the recurrence reads a step three
    frames back, on the output grid."""
    C, K = args["num_ceps"], args["ivector_dim"]
    H, cell, P = args["hidden_dim"], args["cell_dim"], args["proj_dim"]
    lda_dim = len(TDNN_SPLICES[0]) * C + K
    out = [("lda", lda_dim, lda_dim, TDNN_SPLICES[0]), ("tdnn1", lda_dim, H, (0,)),
           ("tdnn2", len(TDNN_SPLICES[1]) * H, H, TDNN_SPLICES[1]),
           ("tdnn3", len(TDNN_SPLICES[2]) * H, H, TDNN_SPLICES[2])]

    def lstm(name):
        return [(f"{name}.W_all", H + P, 4 * cell, (0,)), (f"{name}.W_rp", cell, 2 * P, (0,))]

    out += lstm("lstm1")
    for i, name in ((4, "lstm2"), (6, "lstm3")):
        out += [(f"tdnn{i}", MID_SPLICE * 2 * P, H, (0,)),
                (f"tdnn{i + 1}", MID_SPLICE * H, H, (0,))]
        out += lstm(name)
    return out + [("output", 2 * P, args["num_pdfs"], (0,))]
