"""The port's native runtime copy (``rhasspy_speech_torch/native/runtime.py``)
against two faults it shared with the JAX package's (ROADMAP Queue 3, P6).

- The ADPCM drain encoder checks its arrays with exceptions, not asserts,
  so a wrong dtype or a non-contiguous array raises under ``python -O``
  too, on the native path and the NumPy one alike.
- The library is built into the port's own directory and stamped with the
  ``-march`` target it was built for and a key of the host's instruction
  flags; a stamp of another host, or none, rebuilds it, and a stamp of
  this host loads it without starting g++. A library built for another
  host's instructions is not loaded when the rebuild fails.
"""

import os

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from rhasspy_speech_torch.native import runtime as rt

REPO = Path(__file__).resolve().parents[1]


def test_library_builds_into_the_ports_directory():
    assert rt._LIB_PATH.parent == REPO / "rhasspy_speech_torch" / "native" / "build"
    assert rt._STAMP_PATH.parent == rt._LIB_PATH.parent
    assert rt._LIB_PATH != REPO / "native" / "build" / "librss_runtime.so"


@pytest.mark.parametrize("bad, error", [("dtype", "TypeError"), ("out_dtype", "TypeError"),
                                        ("strides", "ValueError")])
def test_encoder_checks_survive_optimize(bad, error):
    """Under ``python -O`` (asserts stripped) the encoder still refuses a
    wrong dtype and a non-contiguous array."""
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        sys.path.insert(0, {str(REPO)!r})
        from rhasspy_speech_torch.native.runtime import adpcm_encode_into
        assert sys.flags.optimize == 0  # never runs: -O strips it
        samples = np.zeros((2, 320), np.float32)
        out = np.zeros((2, 200), np.uint8)
        if {bad!r} == "dtype":
            samples = samples.astype(np.float64)
        elif {bad!r} == "out_dtype":
            out = out.astype(np.int8)
        else:
            samples = np.zeros((2, 640), np.float32)[:, ::2]
        try:
            adpcm_encode_into(samples, np.array([320, 320]), 160, out)
        except {error} as err:
            print("raised", type(err).__name__)
    """)
    res = subprocess.run([sys.executable, "-O", "-c", script], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"raised {error}"


HOST = "x86_64-0123456789abcdef"


def _fake_build(monkeypatch, tmp_path, target, fail_build=False):
    """Point the runtime at ``tmp_path`` on a host of key ``HOST`` and
    replace ``subprocess.run``: g++ reports ``target`` for
    ``-march=native``, a build writes its output file (or fails). Returns
    the library's path and the list of commands run."""
    lib = tmp_path / "build" / "librss_runtime.so"
    monkeypatch.setattr(rt, "_LIB_PATH", lib)
    monkeypatch.setattr(rt, "_STAMP_PATH", lib.with_suffix(".march"))
    monkeypatch.setattr(rt, "_host_key", lambda: HOST)
    runs = []

    def run(cmd, **kwargs):
        runs.append(cmd)
        if "--help=target" in cmd:
            return subprocess.CompletedProcess(cmd, 0, stdout=f"  -march=  \t\t{target}\n", stderr="")
        if fail_build:
            raise FileNotFoundError("g++")
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"not a shared object")
        return subprocess.CompletedProcess(cmd, 0, stdout="", stderr="")

    monkeypatch.setattr(rt.subprocess, "run", run)
    lib.parent.mkdir()
    return lib, runs


def _builds(runs):
    return [cmd for cmd in runs if "-o" in cmd]


@pytest.mark.parametrize("stamp, rebuilds", [
    pytest.param(f"znver3 {HOST}", False, id="znver3-False"),
    pytest.param("sapphirerapids x86_64-fedcba9876543210", True, id="sapphirerapids-True"),
    pytest.param("znver3", True, id="one-field-True"),
    pytest.param(None, True, id="None-True"),
])
def test_stamp_decides_rebuild(monkeypatch, tmp_path, stamp, rebuilds):
    """A stamp of this host loads the library without starting any
    process; one of another host, of the one-field form or none rebuilds
    it for g++'s target and stamps the target and this host."""
    lib, runs = _fake_build(monkeypatch, tmp_path, "znver3")
    lib.write_bytes(b"an earlier build")
    if stamp is not None:
        lib.with_suffix(".march").write_text(stamp + "\n")
    rt.NativeRuntime().lib  # the fake library does not load: NumPy fallbacks
    if rebuilds:
        assert len(_builds(runs)) == 1 and "-march=native" in _builds(runs)[0]
        assert lib.read_bytes() == b"not a shared object"
    else:
        assert runs == []
    assert lib.with_suffix(".march").read_text().split() == ["znver3", HOST]


def test_host_key_reads_no_compiler(monkeypatch):
    """The key is read from the CPU's flags, the same on every call, with
    no process started."""
    def run(cmd, **kwargs):
        raise AssertionError(f"started {cmd}")

    monkeypatch.setattr(rt.subprocess, "run", run)
    key = rt._host_key()
    assert key == rt._host_key() and len(key.split()) == 1 and "-" in key


def test_failed_rebuild_loads_no_library_of_another_target(monkeypatch, tmp_path):
    """Without a compiler a library stamped for another host's
    instructions is left unloaded (it could die on an illegal
    instruction); one stamped ``generic``, or one built on this host from
    an older source, is loaded as before."""
    lib, runs = _fake_build(monkeypatch, tmp_path, "znver3", fail_build=True)
    lib.write_bytes(b"an earlier build")
    os.utime(lib, (0, 0))  # older than the source: a rebuild is due
    loaded = []
    monkeypatch.setattr(rt.ctypes, "CDLL", lambda path: loaded.append(path) or None)
    monkeypatch.setattr(rt.NativeRuntime, "_configure", staticmethod(lambda lib: None))
    lib.with_suffix(".march").write_text("sapphirerapids x86_64-fedcba9876543210\n")
    assert rt.NativeRuntime().lib is None and not loaded
    assert [("-march=native" in cmd) for cmd in _builds(runs)] == [True, False]
    for stamp in ("generic x86_64-fedcba9876543210", f"sapphirerapids {HOST}"):
        lib.with_suffix(".march").write_text(stamp + "\n")
        rt.NativeRuntime().lib
    assert loaded == [str(lib)] * 2
