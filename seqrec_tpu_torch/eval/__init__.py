"""Serving-side eval code: score masking and batch inference (`recommend`)."""
