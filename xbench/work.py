"""The yardstick's arithmetic: the least time the card needs for a piece
of work, from its operations and bytes at the H100's published peaks.

Frozen copies, so that a change to the program cannot move the
yardstick: the peaks are those of ``src/repro_torch/launch/roofline.py``
(``PEAK_FLOPS``, ``HBM_BW``: NVIDIA's H100 SXM data sheet, dense bf16
on the tensor cores, HBM3, at the 700 W limit), and the byte model of a
decode step's MoE layer is ``moe_step_bytes`` of
``src/repro_torch/kernels/ops.py`` (3 d f weight elements an activated
expert, read once), both at commit 42b2fa7. Counted once: each weight a
step or a kernel touches, each activation row it reads or writes, and
the KV rows attended to; a matrix product of m x n x k is 2 m n k
operations. Where a count depends on the data and the program does not
report it (the experts a prefill touches), it is the expected count
E (1 - (1 - k/E)^rows) of routing that many rows.
"""
from __future__ import annotations

from typing import Dict, Sequence

PEAK_FLOPS = 989e12      # bf16 FLOP/s, tensor cores, dense
HBM_BW = 3.35e12         # bytes/s of HBM3


def least_s(flops: float, nbytes: float) -> float:
    """The roofline's least time: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)


def dims(cfg: Dict) -> Dict:
    H, Hkv, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    d = cfg["hidden_size"]
    return {"d": d, "L": cfg["num_hidden_layers"], "H": H, "Hkv": Hkv,
            "dh": dh, "E": cfg["n_routed_experts"],
            "k": cfg["num_experts_per_tok"],
            "f": cfg["moe_intermediate_size"],
            "fs": cfg["moe_intermediate_size"] * cfg["n_shared_experts"],
            "V": cfg["vocab_size"],
            "attn": d * H * dh * 2 + d * Hkv * dh * 2}


def expected_experts(E: int, k: int, rows: int) -> float:
    """Experts that ``rows`` tokens, each routed to k of E at random,
    touch on average."""
    return E * (1.0 - (1.0 - k / E) ** rows)


def expert_ffn(cfg: Dict, tokens: int, activated: float,
               elem: int = 2) -> Dict:
    """One routed-expert FFN call: ``tokens`` rows in, each to top_k
    experts, ``activated`` experts' weights read once; the rows read
    and written once; 6 d f operations a routed pair."""
    m = dims(cfg)
    nbytes = activated * 3 * m["d"] * m["f"] * elem \
        + 2 * tokens * m["d"] * elem
    flops = 6.0 * tokens * m["k"] * m["d"] * m["f"]
    return {"flops": flops, "bytes": nbytes}


def decode_step(cfg: Dict, tokens: int, activated: Sequence[float],
                attended: int, elem: int = 2) -> Dict:
    """One decode step of ``tokens`` live rows: every layer's dense
    weights, router (f32) and shared expert, its ``activated[l]``
    experts, the KV rows attended to (``attended`` over all rows) and
    the new ones written; the embedding rows and the head."""
    m = dims(cfg)
    d, Hkv, dh = m["d"], m["Hkv"], m["dh"]
    kv_row = 2 * Hkv * dh * elem
    nbytes, flops = 0.0, 0.0
    for a in map(float, activated):
        nbytes += (m["attn"] + 3 * d * m["fs"] + 2 * d) * elem \
            + d * m["E"] * 4 + a * 3 * d * m["f"] * elem \
            + attended * kv_row + tokens * kv_row
        flops += 2.0 * tokens * (m["attn"] + d * m["E"] + 3 * d * m["fs"]
                                 + m["k"] * 3 * d * m["f"]) \
            + 4.0 * attended * m["H"] * dh
    nbytes += (d * m["V"] + tokens * d + tokens * m["V"]) * elem
    flops += 2.0 * tokens * d * m["V"]
    return {"flops": flops, "bytes": nbytes}


def prefill(cfg: Dict, rows: int, elem: int = 2) -> Dict:
    """A prefill of ``rows`` prompt tokens, the first token's logits
    only: every layer's dense weights, the experts the rows touch, the
    KV written, causal attention (2 rows^2 H dh), the head once."""
    m = dims(cfg)
    d, dh = m["d"], m["dh"]
    act = expected_experts(m["E"], m["k"], rows)
    nbytes = m["L"] * ((m["attn"] + 3 * d * m["fs"] + 2 * d) * elem
                       + d * m["E"] * 4 + act * 3 * d * m["f"] * elem
                       + rows * 2 * m["Hkv"] * dh * elem)
    flops = m["L"] * (2.0 * rows * (m["attn"] + d * m["E"]
                                    + 3 * d * m["fs"]
                                    + m["k"] * 3 * d * m["f"])
                      + 2.0 * rows * rows * m["H"] * dh)
    nbytes += (d * m["V"] + rows * d) * elem
    flops += 2.0 * d * m["V"]
    return {"flops": flops, "bytes": nbytes}
