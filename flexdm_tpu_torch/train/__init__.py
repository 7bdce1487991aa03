"""Trainer, optimizer and checkpoints of the port."""
