"""The port's counterpart of tests/test_models_smoke.py, on the CPU.

Every config of ``repro_torch.configs.registry.ARCHS``, reduced (2
layers, d_model <= 512, <= 4 experts), runs through the port alone, as
the reference's smoke tests run the JAX package: one forward and one
make_train_step step (shapes, finite values, parameters moved); prefill
of S - 1 tokens, then one decode_step, equal to the full forward's last
two positions within 3e-4; and each MoE config decoding under
XSharePolicy(mode="batch").

Then the five configs whose forward no other port test holds against
the JAX package, at the same reduced widths in f32, on the same weights
(the port's f32 draw, norm scales drawn around 1, carried into JAX as
it is) and tokens: logits and the MoE configs' per-layer lb_loss aux
within 2e-5, loss_fn within 2e-5. They carry the branches no other port test holds
against JAX: deepseek-r1-proxy's shared expert, gpt-oss-120b-proxy's
normalized top-4 gates and qwen3-moe-235b-a22b's q / k norms, beside the
dense granite-3-8b and mistral-nemo-12b."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import XSharePolicy  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.launch.train import make_train_step  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models.moe import policy_max_active  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

TOL = 2e-5
DECODE_TOL = 3e-4                      # tests/test_models_smoke.py:88
MOE_ARCHS = [n for n, c in ARCHS.items() if c.moe is not None]
# the configs whose forward no other port test holds against JAX's
JAX_ARCHS = ("deepseek-r1-proxy", "gpt-oss-120b-proxy", "qwen3-moe-235b-a22b",
             "granite-3-8b", "mistral-nemo-12b")


def toks_of(cfg, B: int, S: int, seed: int) -> torch.Tensor:
    shape = (B, S, cfg.num_codebooks) if cfg.family == "audio" else (B, S)
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32))


def prefix_of(cfg, B: int, seed: int):
    if not cfg.prefix_len:
        return None
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (B, cfg.prefix_len, cfg.d_model)).astype(np.float32))


def reduced(name):
    return ARCHS[name].reduced()


def port_params(cfg):
    return bridge.init_params(cfg, seed=0, dtype=torch.float32,
                              device="cpu")


@pytest.mark.parametrize("name", list(ARCHS))
def test_reduced_forward_and_train_step(name):
    cfg = reduced(name)
    assert cfg.num_layers == 2 and cfg.d_model <= 512
    if cfg.moe:
        assert cfg.moe.num_experts <= 4
    params = port_params(cfg)
    B, S = 2, 32
    toks, pe = toks_of(cfg, B, S, 0), prefix_of(cfg, B, 0)
    with torch.no_grad():
        logits, _ = TMD.forward(cfg, params, toks, prefix_embeds=pe)
    frames = (cfg.num_codebooks,) if cfg.family == "audio" else ()
    assert logits.shape == (B, S + cfg.prefix_len) + frames + \
        (cfg.padded_vocab,)
    assert torch.isfinite(logits).all()

    step = make_train_step(cfg, lr=1e-3, remat=False)
    new, _, m = step(params, adamw_init(params), toks, prefix_embeds=pe)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    flat_new, flat_old = bridge.flatten(new), bridge.flatten(params)
    assert all(torch.isfinite(v).all() for v in flat_new.values())
    assert any(float((flat_new[k] - v).abs().max()) > 0
               for k, v in flat_old.items())


@pytest.mark.parametrize("name", list(ARCHS))
def test_reduced_prefill_decode_consistency(name):
    """prefill + decode_step logits == the full forward's (the serving
    invariant), drop-free MoE capacity."""
    cfg = reduced(name)
    params = port_params(cfg)
    B, S = 2, 17
    toks, pe = toks_of(cfg, B, S, 1), prefix_of(cfg, B, 1)
    P = cfg.prefix_len
    with torch.no_grad():
        full, _ = TMD.forward(cfg, params, toks, prefix_embeds=pe,
                              capacity_factor=99.0)
        last, cache, _ = TMD.prefill(cfg, params, toks[:, :S - 1],
                                     cache_len=64, prefix_embeds=pe,
                                     capacity_factor=99.0)
        dec, cache, _ = TMD.decode_step(cfg, params, toks[:, S - 1:S],
                                        cache, capacity_factor=99.0)
    np.testing.assert_allclose(last.numpy(), full[:, P + S - 2].numpy(),
                               atol=DECODE_TOL)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, P + S - 1].numpy(),
                               atol=DECODE_TOL)
    assert (cache["cur_len"] == P + S).all()


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_arch_decodes_under_batch_selection(name):
    """tests/test_models_smoke.py:97 for every MoE config: a decode step
    under XSharePolicy(mode="batch") gives finite logits and keeps the
    activated and selected sets within the budget."""
    cfg = reduced(name)
    params = port_params(cfg)
    toks = toks_of(cfg, 2, 16, 2)
    pol = XSharePolicy(mode="batch", k0=1, m_l=1)
    with torch.no_grad():
        _, cache, _ = TMD.prefill(cfg, params, toks, cache_len=64)
        lg, _, aux = TMD.decode_step(cfg, params, toks[:, -1:], cache,
                                     policy=pol)
    assert torch.isfinite(lg).all()
    E = cfg.moe.num_experts
    budget = policy_max_active(pol, 2, E)
    assert int(aux["selected_set"].max()) <= E
    assert int(aux["activated_experts"].max()) <= budget


# ------------------------------------------------------ against JAX ---

_JAX_PARAMS = {}


def jax_pair(name):
    """(JAX config, port config, JAX params, port params): the port's
    f32 draw with every norm scale set to 1 + 0.1 N(0, 1) (at their
    initial ones a swapped or misplaced norm leaf would go unseen),
    carried into JAX as it is (JAX's own init_params costs seconds a
    config here; its keys, shapes and dtypes are the port's), built once
    per config."""
    if name not in _JAX_PARAMS:
        jcfg, tcfg = JARCHS[name].reduced(), reduced(name)
        flat = bridge.flatten(port_params(tcfg))
        rng = np.random.default_rng(6)
        for k in sorted(flat):
            if k.endswith("norm"):
                flat[k] = torch.as_tensor(1 + 0.1 * rng.standard_normal(
                    tuple(flat[k].shape)).astype(np.float32))
        tp = bridge.unflatten(flat)
        jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
        _JAX_PARAMS[name] = jcfg, tcfg, jp, tp
    return _JAX_PARAMS[name]


def jax_inputs(cfg, seed: int):
    """(port tokens, port prefix, the same as JAX keywords)."""
    toks, pe = toks_of(cfg, 2, 24, seed), prefix_of(cfg, 2, seed)
    kw = {} if pe is None else {"prefix_embeds": jnp.asarray(pe.numpy())}
    return toks, pe, jnp.asarray(toks.numpy()), kw


def close(t, j):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", JAX_ARCHS)
def test_reduced_forward_matches_jax(name):
    jcfg, tcfg, jp, tp = jax_pair(name)
    layers = tp["layers"]
    if name == "deepseek-r1-proxy":
        assert "ws1" in layers["moe"]             # the shared expert
    if name == "qwen3-moe-235b-a22b":
        assert {"q_norm", "k_norm"} <= set(layers["attn"])
    toks, pe, jtoks, jkw = jax_inputs(tcfg, 4)
    ref, raux = JMD.forward(jcfg, jp, jtoks, **jkw)
    with torch.no_grad():
        out, aux = TMD.forward(tcfg, tp, toks, prefix_embeds=pe)
    close(out, ref)
    if tcfg.moe is not None:
        close(aux["lb_loss"], raux["lb_loss"])


@pytest.mark.parametrize("name", JAX_ARCHS)
def test_reduced_loss_matches_jax(name):
    jcfg, tcfg, jp, tp = jax_pair(name)
    toks, pe, jtoks, jkw = jax_inputs(tcfg, 5)
    ref, _ = JMD.loss_fn(jcfg, jp, jtoks, remat=False, **jkw)
    with torch.no_grad():
        out, _ = TMD.loss_fn(tcfg, tp, toks, prefix_embeds=pe, remat=False)
    assert abs(float(out) - float(ref)) <= TOL, (float(out), float(ref))


def test_init_params_draws_each_leaf_once_in_its_dtype():
    """bridge.init_params draws every dense leaf in place in its own
    dtype (how 8 layers of gpt-oss-120b-proxy's 17 GB of bf16 experts
    fit one card): the keys, shapes and dtypes of the f32 tree, N(0,
    0.02) values, each expert its own draw, and the same numbers from
    the same seed."""
    cfg = reduced("gpt-oss-120b-proxy")
    ref = bridge.flatten(port_params(cfg))
    runs = [bridge.flatten(bridge.init_params(cfg, seed=0,
                                              dtype=torch.bfloat16,
                                              device="cpu"))
            for _ in range(2)]
    assert {k: v.shape for k, v in runs[0].items()} == \
        {k: v.shape for k, v in ref.items()}
    assert runs[0]["layers/moe/w1"].dtype == torch.bfloat16
    assert {k: v.dtype for k, v in runs[0].items()} == \
        {k: v.dtype for k, v in bridge.flatten(bridge.init_params(
            cfg, seed=0, dtype=torch.bfloat16, device="meta")).items()}
    w1 = runs[0]["layers/moe/w1"]                 # (L, E, d, f)
    assert abs(float(w1.float().std()) - 0.02) < 1e-3
    assert not torch.equal(w1[0, 0], w1[0, 1])
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k])
