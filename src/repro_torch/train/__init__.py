"""Serving-side steps of the training package (greedy decoding)."""
