"""The training step: loss, optimizer and schedule, trainer."""
