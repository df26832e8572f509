"""Synthetic language-modeling data: seeded Markov-chain token streams
(``synthetic.py``), the same module as the JAX package's ``repro.data``."""
from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticLM, batches, make_dataset_family, mixed_request_batch,
)
