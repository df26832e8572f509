"""XShare core — batch-aware expert selection (the paper's contribution)."""
from repro_torch.core.selection import (  # noqa: F401
    topk_mask, warmup_union, greedy_select, batch_select,
    per_request_select, spec_select, ep_select, restricted_topk,
    apply_policy, gate_histogram, affinity_score, rank_by_affinity,
)
from repro_torch.core import routing, metrics  # noqa: F401
from repro_torch.configs.base import XSharePolicy  # noqa: F401
