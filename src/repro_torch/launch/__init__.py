"""Launchers of the port: ``train`` (the training step and its CLI),
``serve`` (the serving step factories and CLI), ``inputs`` (meta-device
input stand-ins per arch x shape), ``roofline`` (a step's bounds on the
H100), and the planning tools: ``mesh`` and ``partition`` (mesh
descriptions and the partition rules), ``dryrun`` (every arch x shape x
mesh traced on meta, with per-card state and roofline), ``hillclimb``
(three planning experiments), ``report`` and ``gen_experiments``
(tables and the EXPERIMENTS document)."""
