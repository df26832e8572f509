from repro_torch.models.model import (  # noqa: F401
    Model, decode_step, embed_tokens, evict_slot, forward, init_cache,
    insert_request, lm_head_apply, prefill,
)
