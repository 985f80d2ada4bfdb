"""Runnable examples of the port (``python -m rhasspy_speech_torch.examples.<name>``)."""
