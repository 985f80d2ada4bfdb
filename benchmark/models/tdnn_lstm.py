"""A TDNN-LSTM model directory, written by the port's seeded writer
(``testing/full_width.py:write_tdnn_lstm_model_dir``) over the big grammar's
phones, with the ``model/phones.txt`` a trained Kaldi model carries."""

from __future__ import annotations

from pathlib import Path
from typing import Dict


def write(model_dir: Path, args: Dict, seed: int) -> Path:
    from rhasspy_speech_torch.testing.big_grammar import PHONES
    from rhasspy_speech_torch.testing.full_width import write_tdnn_lstm_model_dir

    model_dir = write_tdnn_lstm_model_dir(
        model_dir, num_pdfs=args["num_pdfs"], max_phone=len(PHONES),
        hidden_dim=args["hidden_dim"], cell_dim=args["cell_dim"], proj_dim=args["proj_dim"],
        ivector_dim=args["ivector_dim"], ubm_gauss=args["ubm_gauss"],
        num_ceps=args["num_ceps"], seed=seed)
    with open(Path(model_dir) / "model" / "phones.txt", "w", encoding="utf-8") as f:
        f.write("<eps> 0\n")
        for i, p in enumerate(PHONES):
            f.write(f"{p} {i + 1}\n")
    return Path(model_dir)
