"""Training: the poly schedule, the optimizer, the train state and the
train step of the source-only modes."""
