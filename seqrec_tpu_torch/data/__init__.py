"""Training-side data code: negative samplers (the batch pipeline comes
with the fit-loop slice)."""
