"""Training: optimizer assembly, train state and the single-GPU step."""
