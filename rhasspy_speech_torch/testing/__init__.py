"""Fixtures of the port: the flagship decode graph and full-width TDNN-F
model directories (``flagship.py``, ``tdnnf.py``), built from a seed."""
