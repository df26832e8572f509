"""Launchers of the port: ``train`` (the training step and its CLI),
``serve`` (the serving step factories and CLI), ``inputs`` (meta-device
input stand-ins per arch x shape) and ``roofline`` (a step's bounds on
the H100)."""
