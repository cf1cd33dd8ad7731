"""Training: the train state, schedules and optimizer (`state`) and the
training step (`trainer.Trainer`)."""
