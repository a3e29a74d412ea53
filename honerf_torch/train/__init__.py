"""Training-side modules: checkpoints, the eval render and the full-image loop."""
