"""The model's weights, drawn from the seed on the device in the dtype
they are served in, one in-place draw a leaf, in the parameter layout
the program takes (the JAX package's keys: ``layers/moe/w1`` and the
like, layers stacked on a leading axis). Both the program and the
reference read these same tensors."""
from __future__ import annotations

from typing import Dict

import torch

STD = 0.02   # every matrix ~ N(0, STD); norm weights are 1


def padded_vocab(cfg: Dict) -> int:
    return -(-int(cfg["vocab_size"]) // 256) * 256


def draw(cfg: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The parameter tree of configuration ``cfg`` (a config file's
    dict) from ``seed``. The router stays float32, as the program keeps
    it."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))

    def normal(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device).normal_(
            0.0, STD, generator=g)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, Hkv, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    E, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    V = padded_vocab(cfg)
    moe = {"wg": normal(L, d, E, dt=torch.float32),
           "w1": normal(L, E, d, f), "w3": normal(L, E, d, f),
           "w2": normal(L, E, f, d)}
    fs = f * cfg["n_shared_experts"]
    if fs:
        moe.update(ws1=normal(L, d, fs), ws3=normal(L, d, fs),
                   ws2=normal(L, fs, d))
    tree = {"embed": normal(V, d),
            "layers": {"attn_norm": ones(L, d),
                       "attn": {"wq": normal(L, d, H * dh),
                                "wk": normal(L, d, Hkv * dh),
                                "wv": normal(L, d, Hkv * dh),
                                "wo": normal(L, H * dh, d)},
                       "moe_norm": ones(L, d), "moe": moe},
            "final_norm": ones(d)}
    if cfg.get("qk_norm"):
        tree["layers"]["attn"].update(q_norm=ones(L, dh), k_norm=ones(L, dh))
    if not cfg["tie_word_embeddings"]:
        tree["lm_head"] = normal(d, V)
    return tree
