"""Small sizes of the benchmark's cells for the CPU tests: each cell's
own files with the widths cut so a run takes seconds on a host."""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from xbench import harness, weights  # noqa: E402

TINY_D = 128
# draw the small widths with the spread a full width of 4096 gives its
# activations and logits (std 0.02 sqrt(4096 / d)), so gaps and faults
# read on the same scale as at the cells' sizes
weights.STD = 0.02 * (4096 / TINY_D) ** 0.5

CPU = torch.device("cpu")
BENCH = harness.Bench(ROOT)
CELLS = [w["name"] for w in BENCH.spec["workloads"]]


def tiny_config(cell: str) -> dict:
    cfg = BENCH.config(BENCH.cell(cell))
    cfg.update(hidden_size=TINY_D, num_attention_heads=4,
               num_key_value_heads=2, head_dim=32, moe_intermediate_size=64,
               vocab_size=512, num_hidden_layers=2,
               n_routed_experts=min(16, cfg["n_routed_experts"]),
               num_experts_per_tok=4)
    if "attention_multiplier" in cfg:
        cfg["attention_multiplier"] = cfg["head_dim"] ** -0.5
    return cfg


def tiny_mix(cell: str) -> dict:
    mix = BENCH.mix(BENCH.cell(cell))
    mix.update(clients=4, prompt_len=[8, 32], answer_len=[16, 48],
               cache_len=96, warmup_s=0.3, trace_s=0.5, table=32)
    return mix


# every completed request is compared, so a fault in one slot is always
# in the sample at these few requests
LIMITS = {"sample_requests": 1000,
          "limits": {"mean_gap": 0.1, "worst_request_gap": 0.3}}


def tiny_run(cell: str, seed: int = 5, seconds: float = 3.0, **kw):
    return harness.run_cell(BENCH, cell, seed, seconds, False, device=CPU,
                            t_start=time.perf_counter(),
                            cfg=tiny_config(cell), mix=tiny_mix(cell),
                            limits=LIMITS, **kw)


def load_json(rel: str) -> dict:
    return json.loads((ROOT / rel).read_text())
