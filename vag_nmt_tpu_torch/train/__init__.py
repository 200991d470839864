"""Training: state and optimizer, the train step, checkpoints, the loop."""
