"""The port's copy of the ark/scp table I/O, held to the cases of
``tests/test_table.py``; its arks read back through the JAX package's copy."""

import numpy as np

from rhasspy_speech_tpu.io.table import read_ark_dict as jax_read_ark_dict
from rhasspy_speech_torch.io.table import (
    read_ark,
    read_ark_dict,
    read_scp,
    write_ark,
)


def test_ark_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    items = [
        ("utt1", rng.randn(5, 13).astype(np.float32)),
        ("utt2", rng.randn(3, 13).astype(np.float32)),
        ("vec1", rng.randn(7).astype(np.float32)),
    ]
    path = tmp_path / "feats.ark"
    write_ark(path, items)
    got = read_ark_dict(path)
    assert set(got) == {"utt1", "utt2", "vec1"}
    for key, arr in items:
        np.testing.assert_allclose(got[key], arr, rtol=1e-6)
    want = jax_read_ark_dict(path)
    assert set(want) == set(got)
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])


def test_scp_reading(tmp_path):
    rng = np.random.RandomState(1)
    items = [("a", rng.randn(4, 2).astype(np.float32)),
             ("b", rng.randn(2, 2).astype(np.float32))]
    ark = tmp_path / "x.ark"
    write_ark(ark, items)
    # build the scp with byte offsets (offset points at the \0B header)
    offsets = {}
    with open(ark, "rb") as f:
        data = f.read()
    pos = 0
    for key, _ in items:
        keyb = (key + " ").encode()
        pos = data.index(keyb, pos) + len(keyb)
        offsets[key] = pos
    scp = tmp_path / "x.scp"
    with open(scp, "w") as f:
        for key, _ in items:
            print(f"{key} {ark}:{offsets[key]}", file=f)
    got = dict(read_scp(scp))
    for key, arr in items:
        np.testing.assert_allclose(got[key], arr, rtol=1e-6)
