"""Launchers of the port: ``train`` (the training step and its CLI)."""
