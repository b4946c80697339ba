"""Training loop, evaluation, LR schedulers and prediction drivers."""
