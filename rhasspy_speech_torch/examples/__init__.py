"""Runnable examples of the port (``python -m rhasspy_speech_torch.examples.<name>``).

Counterparts of the repository's JAX ``examples/``, each taking ``--device``
(``cuda`` by default, raising without a card; ``cpu`` runs the plain twins)
and exposing ``main(argv) -> dict``, which returns what it printed:

- ``serve_streams``: N realtime streams through the stream scheduler with
  endpointing, over the i16, mu-law or ADPCM wire;
- ``serve_multichip``: ``ShardedWavTranscriber`` over a stream mesh, held
  equal to one device's transcripts;
- ``inspect_utterance``: one utterance's transcript, confidence, n-best
  rivals and lattice ark;
- ``rescore_oov``: the dual-graph OOV flow, a lattice rescore recovering a
  word the first-pass graph lacks;
- ``tick_device_profile``: the serving tick split into device execute,
  upload and host side at the flagship's width;
- ``decode_roofline``: each batch stage's time, bytes, operations and share
  of the card's roofline;
- ``frontier_curve``: the top-K frontier's cost regret and best-path
  agreement against K;
- ``windowed_cost``: the windowed relaxation (K3) at
  ``examples/pallas_windowed_cost.py``'s shape;
- ``pitch_viterbi_sweep``: K5 at every cluster size (no JAX counterpart).

Not ported, on purpose: ``examples/pallas_decode_bench.py`` (K2 against its
plain twin at serving batch sizes is ``chip_smoke.py``'s own check) and
``examples/pallas_windowed_cost.py`` itself (done as K3, ``windowed_cost``).
"""
