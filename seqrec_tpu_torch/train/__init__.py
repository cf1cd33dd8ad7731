"""Training: the train state, schedules and optimizer (`state`), the
sparse row-wise embedding updates (`sparse_embed`), checkpoints
(`checkpoint`) and the training step and fit loop (`trainer.Trainer`)."""
