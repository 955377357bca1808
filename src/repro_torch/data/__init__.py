"""Synthetic LM data (numpy only, bit for bit with the reference)."""
