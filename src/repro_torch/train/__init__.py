"""Training: losses, optimizers and the train / serve step factories."""
