"""The reference against the port at a small size of each cell, policy
off and Algorithm 2, and its parts against the port's own."""
import numpy as np
import pytest
import torch

from xbench_tiny import CELLS, tiny_config, tiny_run

from repro_torch.core import selection
from repro_torch.models.model import forward
from xbench import program, weights as W
from xbench.reference.model import Reference, served_batch


@pytest.mark.parametrize("cell", CELLS)
def test_served_tokens_match_reference(cell):
    r = tiny_run(cell)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["correct"], r["checks"]
    assert r["sample"]["tokens"] > 20
    assert r["checks"]["mean_gap"]["value"] < 0.1


@pytest.mark.parametrize("cell", CELLS)
def test_reference_forward_matches_port_in_f32(cell):
    cfg = tiny_config(cell)
    tree = W.draw(cfg, 11, torch.device("cpu"), dtype=torch.float32)
    toks = torch.randint(0, cfg["vocab_size"], (1, 40),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want, _ = forward(program.arch_config(cfg), tree, toks)
    ref = Reference(cfg, tree, {"mode": "off"})
    batch = served_batch([{"rid": 0, "prompt": toks[0, :1].numpy(),
                           "tokens": toks[0, 1:].numpy(),
                           "steps": np.full(39, -1)}])
    batch.need[:] = True
    h = ref.final_hidden(batch)
    stats = ref.head_stats(h, toks[0, 1:])
    V = cfg["vocab_size"]
    got = want[0, :-1, :V]
    assert torch.allclose(stats["best"], got.max(-1).values, atol=1e-4)
    assert torch.equal(stats["argmax"], got.argmax(-1))


@pytest.mark.parametrize("seed", range(4))
def test_algorithm2_matches_port(seed):
    g = torch.Generator().manual_seed(seed)
    E, k, T = 32, 8, 16
    logits = torch.randn((2 * T, E), generator=g) * 2
    probs = torch.softmax(logits, -1)
    pol = {"mode": "batch", "k0": 1, "m_l": 4}
    ref = Reference({"num_attention_heads": 1, "num_key_value_heads": 1,
                     "head_dim": 2, "num_experts_per_tok": k,
                     "n_routed_experts": E, "rms_norm_eps": 1e-6,
                     "norm_topk_prob": True}, {}, pol)
    step = torch.tensor([5] * T + [9] * T)
    idx, w = ref._route(logits, step)
    xp = program.policy({"mode": "batch", "k0": 1, "m_l_per_expert": 4 / E},
                        {"n_routed_experts": E})
    for half in (slice(0, T), slice(T, 2 * T)):
        p_idx, p_w, _ = selection.apply_policy(
            probs[half], xp, top_k=k, logits=logits[half])
        assert torch.equal(idx[half], p_idx)
        assert torch.allclose(w[half], p_w, atol=1e-6)
