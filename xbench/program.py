"""What the benchmark takes from the program under test, the PyTorch
port ``repro_torch``: its configuration types, built from a config
file's dict, and the XShare policy a mix names. Everything else the
benchmark reaches through ``repro_torch.serving.Engine``."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (ArchConfig, AttnConfig, MoEConfig,
                                      XSharePolicy)


def arch_config(cfg: Dict) -> ArchConfig:
    """The program's ArchConfig of a config file. The keys it cannot
    express are refused unless they hold the value the program
    computes with (the file lists them as changed from the source)."""
    for key, neutral in (("embedding_multiplier", 1.0),
                         ("residual_multiplier", 1.0),
                         ("logits_scaling", 1.0),
                         ("routed_scaling_factor", 1.0),
                         ("first_k_dense_replace", 0),
                         ("scoring_func", "softmax")):
        if cfg.get(key, neutral) != neutral:
            raise ValueError(f"{cfg['name']}: {key} = {cfg[key]!r}; the "
                             f"program computes with {neutral!r}")
    dh = cfg["head_dim"]
    if cfg.get("attention_multiplier", dh ** -0.5) != dh ** -0.5:
        raise ValueError(f"{cfg['name']}: attention_multiplier must be "
                         f"1/sqrt(head_dim)")
    f = cfg["moe_intermediate_size"]
    return ArchConfig(
        name=cfg["name"], family="moe",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        d_ff=0, vocab_size=cfg["vocab_size"],
        attn=AttnConfig(num_heads=cfg["num_attention_heads"],
                        num_kv_heads=cfg["num_key_value_heads"],
                        head_dim=dh, rope_theta=float(cfg["rope_theta"]),
                        qk_norm=bool(cfg.get("qk_norm", False))),
        moe=MoEConfig(num_experts=cfg["n_routed_experts"],
                      top_k=cfg["num_experts_per_tok"], d_ff_expert=f,
                      num_shared_experts=cfg["n_shared_experts"],
                      d_ff_shared=f if cfg["n_shared_experts"] else 0,
                      normalize_gates=bool(cfg["norm_topk_prob"])),
        moe_every=1, tie_embeddings=bool(cfg["tie_word_embeddings"]),
        norm_eps=float(cfg["rms_norm_eps"]))


def policy(spec: Dict, cfg: Dict) -> XSharePolicy:
    """A mix's policy: ``off``, or Algorithm 2 (``batch``) with warm-up
    k0 and a budget of m_l_per_expert times the layer's experts."""
    if spec["mode"] == "off":
        return XSharePolicy(mode="off")
    if spec["mode"] == "batch":
        return XSharePolicy(mode="batch", k0=int(spec["k0"]),
                            m_l=batch_budget(spec, cfg))
    raise ValueError(f"unknown policy mode {spec['mode']!r}")


def batch_budget(spec: Dict, cfg: Dict) -> int:
    return int(round(spec["m_l_per_expert"] * cfg["n_routed_experts"]))
