"""Model construction and checkpoints of the port."""
