"""Training-side data code: the dataset container and its synthetic
generator, the session-parallel window stream, and the negative samplers
(the bucketed batcher and the loaders come with the fit-loop slice)."""
