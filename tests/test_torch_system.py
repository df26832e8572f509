"""The paper's five claims on a model the port trains itself, stated as
tests/test_system.py states them for the JAX package: a 2-layer MoE
(d 64, 4 / 2 heads of 16, 16 experts top-4, f 64, vocab 128) trained for
60 steps of 8 x 64 SyntheticLM tokens with repro_torch's own
make_train_step, AdamW and cosine schedule, then served under XShare
policies:

  1. batch-aware selection activates fewer experts than vanilla top-k;
  2. eval loss degrades gracefully as the budget shrinks;
  3. Algorithm 4 (spec mode) keeps its budget structure;
  4. EP-aware selection bounds the per-group load;
  5. the captured gate mass grows with the budget and stays <= 1.

The model, the recipe and the five (measure, holds) pairs are
chip_smoke.py's (claims_cfg, claims_train, paper_claims), the one
definition its `trained claims` phase holds on the card; here they run
on the CPU (the kernels' plain versions).

This is not a parity test: the port draws its initial weights from a
torch.Generator and JAX from jax.random, so the two trainings start from
different numbers and end at different models. Each claim is held on the
port's model alone, with the reference's thresholds."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")


def chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def claims():
    """Each claim's name -> (measure, holds) on the trained model."""
    cs = chip_smoke()
    params, losses, toks, reqs = cs.claims_train("cpu")
    assert float(losses[-1]) < float(losses[0]), losses
    return {name: (measure, holds) for name, measure, _, _, holds
            in cs.paper_claims(params, toks, reqs)}


def holds(claims, name):
    measure, ok = claims[name]
    with torch.no_grad():
        vals = measure()
    assert ok(vals), vals


def test_batch_selection_reduces_activation(claims):
    holds(claims, "1 batch activates fewer")


def test_quality_budget_tradeoff(claims):
    holds(claims, "2 quality budget")


def test_spec_mode_budget_structure(claims):
    holds(claims, "3 spec budget")


def test_ep_mode_bounds_group_load(claims):
    holds(claims, "4 ep group load")


def test_gate_mass_increases_with_budget(claims):
    holds(claims, "5 gate mass")
