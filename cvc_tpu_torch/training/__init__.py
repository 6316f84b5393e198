"""Training: the cyclical train step, scheduled sampling, SCST, their
optimizer and state, checkpoints and the epoch loop."""
