"""Acoustic models of the port."""
