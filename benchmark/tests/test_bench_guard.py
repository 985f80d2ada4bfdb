"""The no-JAX check compares top-level module names whole."""

from benchmark.harness import guard


def test_top_level_names_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_extension", "flax.linen", "rhasspy_speech_tpu",
             "rhasspy_speech_tpu.ops.decoder"]
    assert guard.forbidden_modules(names) == ["flax", "jax", "jaxlib", "rhasspy_speech_tpu"]


def test_look_alikes_pass():
    names = ["rhasspy_speech_torch", "rhasspy_speech_torch.pipeline", "rhasspy_speech_tpu_x",
             "jaxtyping", "numpy", "my.jax", "rhasspy_speech_t"]
    assert guard.forbidden_modules(names) == []


def test_this_process():
    # the benchmark's own modules and the port load no JAX
    import benchmark.harness.main  # noqa: F401
    import rhasspy_speech_torch.pipeline.scheduler  # noqa: F401
    import sys

    assert guard.forbidden_modules([n for n in sys.modules if n.startswith(("benchmark", "rhasspy"))]) == []
