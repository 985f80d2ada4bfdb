"""CTC acoustic model: a batched PyTorch forward producing per-frame char
probabilities.

Counterpart of ``rhasspy_speech_tpu/models/ctc.py``, which replaces the
Coqui STT TFLite prob server (coqui_stt/native_client/stt_onlyprobs.cpp and
stt.cc StreamingState): a DeepSpeech-shaped net -- dense + ReLU clipped at
20, x3, over context-spliced MFCC windows, a unidirectional LSTM (gate
order i, c, f, o; ``lstm_forget_bias`` added to the forget gate, 1.0 unless
the weights carry it), a post-LSTM dense layer, and a softmax over the
alphabet + blank -- evaluated over [streams, frames].

The parameters are tensors on one device. Every product is a
``torch.matmul`` through cuBLAS on the card (TF32 off, ``device.py``); the
LSTM runs one step a frame, as the JAX package's ``lax.scan`` does, each
step reading the whole ``[D + H, 4H]`` kernel. The Gaussian-classifier
form of the synthetic profiles (a single affine layer + softmax) is the
same code with no hidden layer and no LSTM.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Union

import numpy as np
import torch

from ..device import cached_index, resolve_device


@dataclass
class CtcModel:
    """Parameters + static shape info for the CTC forward. ``params`` are
    tensors on one device (``from_numpy``, ``load``); ``save`` also takes
    NumPy arrays, as ``build_synthetic_ctc_profile`` writes them."""

    params: Dict[str, torch.Tensor]
    num_labels: int  # alphabet size + blank
    context: int = 0  # frames of +-context spliced into the input
    has_lstm: bool = False

    @staticmethod
    def from_numpy(params: Dict[str, np.ndarray], context: int = 0,
                   device: Union[str, torch.device] = "cuda") -> "CtcModel":
        dev = resolve_device(device)
        tensors = {k: torch.as_tensor(np.array(v, np.float32), device=dev)
                   for k, v in params.items()}
        return CtcModel(
            params=tensors,
            num_labels=int(tensors["out_w"].shape[-1]),
            context=int(context),
            has_lstm="lstm_kernel" in tensors,
        )

    @staticmethod
    def load(path: str, device: Union[str, torch.device] = "cuda") -> "CtcModel":
        with np.load(path) as data:
            context = int(data["context"]) if "context" in data else 0
            params = {k: data[k] for k in data.files if k != "context"}
        return CtcModel.from_numpy(params, context, device)

    def save(self, path: str) -> None:
        def host(v):
            return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

        np.savez_compressed(
            path, context=np.asarray(self.context), **{k: host(v) for k, v in self.params.items()}
        )

    @property
    def device(self) -> torch.device:
        return self.params["out_w"].device

    @property
    def lstm_hidden(self) -> int:
        return int(self.params["lstm_bias"].shape[0]) // 4 if self.has_lstm else 0

    def init_state(self, batch: int = 1, dtype=torch.float32) -> Tuple[torch.Tensor, ...]:
        """Zero LSTM carry (h, c) [batch, H] (an empty tuple without an
        LSTM)."""
        if not self.has_lstm:
            return ()
        H = self.lstm_hidden
        return (
            torch.zeros((batch, H), dtype=dtype, device=self.device),
            torch.zeros((batch, H), dtype=dtype, device=self.device),
        )

    @torch.no_grad()
    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, T, D] features -> [B, T, num_labels] label probabilities."""
        x = feats
        if self.context > 0:
            T = x.shape[1]
            parts = [
                x[:, cached_index(np.clip(np.arange(T) + off, 0, T - 1), x.device)]
                for off in range(-self.context, self.context + 1)
            ]
            x = torch.cat(parts, dim=-1)
        probs, _state = self.forward_stream(x, self.init_state(int(feats.shape[0]), x.dtype))
        return probs

    @torch.no_grad()
    def forward_stream(self, spliced: torch.Tensor, state):
        """Stateful window forward for streaming: PRE-SPLICED features
        [B, W, D*(2*context+1)] + LSTM carry -> ([B, W, num_labels],
        carry'). The batch forward is this with zero carry over the whole
        utterance, so windows spliced with true neighbours reproduce it."""
        x = spliced
        p = self.params
        i = 1
        while f"dense{i}_w" in p:
            x = x @ p[f"dense{i}_w"] + p[f"dense{i}_b"]
            x = torch.clamp(x, 0.0, 20.0)  # DeepSpeech's clipped ReLU
            i += 1

        new_state = state
        if self.has_lstm:
            kernel, bias = p["lstm_kernel"], p["lstm_bias"]  # [D + H, 4H], [4H]
            # BasicLSTMCell adds 1.0 to the forget gate at run time;
            # CudnnCompatible exports (real Coqui models) bake it into the
            # bias, so converted weights carry lstm_forget_bias = 0
            forget_bias = p.get("lstm_forget_bias", 1.0)
            h, c = state
            hs = []
            for t in range(x.shape[1]):
                z = torch.cat([x[:, t], h], dim=-1) @ kernel + bias
                i_g, c_g, f_g, o_g = z.chunk(4, dim=-1)
                c = torch.sigmoid(f_g + forget_bias) * c + torch.sigmoid(i_g) * torch.tanh(c_g)
                h = torch.sigmoid(o_g) * torch.tanh(c)
                hs.append(h)
            new_state = (h, c)
            x = torch.stack(hs, dim=1)

        i = 1  # the post-LSTM dense chain (DeepSpeech's layer_5)
        while f"post{i}_w" in p:
            x = torch.clamp(x @ p[f"post{i}_w"] + p[f"post{i}_b"], 0.0, 20.0)
            i += 1

        logits = x @ p["out_w"] + p["out_b"]
        return torch.softmax(logits, dim=-1), new_state
