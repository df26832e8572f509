"""The metric readers' arithmetic over a synthetic run: every sample of
the window counts, a stall moves the rate and the tail, and every share
stays within 0-100 %."""
from types import SimpleNamespace

import numpy as np
import pytest

from xbench_tiny import BENCH

from xbench import harness
from xbench.loop import Round, Run, Served

CFG = BENCH.config(BENCH.cell(BENCH.spec["workloads"][0]["name"]))


def synthetic(stall: float = 0.0, clients: int = 4, rounds: int = 50,
              step: float = 0.01, chunk: int = 8) -> Run:
    """``clients`` requests that never finish, decoding ``chunk`` tokens
    a round of ``chunk * step`` seconds, with a stall of ``stall``
    seconds before each of rounds 25-27; the window is rounds 10-40."""
    reqs, rs, t = {}, [], 0.0
    for c in range(clients):
        st = SimpleNamespace(tokens=[0], t_first_token=0.0, t_admitted=-0.01,
                             status="decode", finish_reason=None)
        reqs[c] = Served(c, c, np.zeros(16, np.int32), 1000, -0.02, st,
                         [(0.0, 1)], 1)
    ends = []
    for k in range(1, rounds + 1):
        t += chunk * step + (stall if 25 <= k <= 27 else 0.0)
        for s in reqs.values():
            s.deliveries.append((t, chunk))
            s.state.tokens.extend([0] * chunk)
        act = np.full((chunk, CFG["num_hidden_layers"]), 20)
        rs.append(Round(k, t, [(c, 1 + (k - 1) * chunk, chunk)
                               for c in reqs], act))
        ends.append(t)
    return Run(cfg=CFG, policy={"mode": "off"}, t_open=ends[9],
               t_close=ends[39], chunk=chunk, requests=reqs, rounds=rs,
               setup_s=3.0)


def val(name, run):
    return harness.reader(name)(run)


def test_rate_counts_every_token_of_the_window():
    run = synthetic()
    assert val("output_tokens_per_s", run) == pytest.approx(
        30 * 8 * 4 / (run.t_close - run.t_open))


def test_stall_moves_rate_and_tail():
    calm, stalled = synthetic(), synthetic(stall=0.5)
    assert val("output_tokens_per_s", stalled) < \
        0.7 * val("output_tokens_per_s", calm)
    assert val("itl_p95_ms", calm) == pytest.approx(10.0)
    # the stalled rounds' tokens wait (80 + 500) / 8 ms each: 96 of the
    # window's 960 samples, more than the 5 % beyond the percentile
    assert val("itl_p95_ms", stalled) == pytest.approx(72.5)
    assert val("decode_step_ms", stalled) > val("decode_step_ms", calm)


def test_tail_is_taken_over_all_samples():
    run = synthetic()
    # one request's every delivery in the window comes 3x slower:
    s = run.requests[0]
    s.deliveries = [(t * 3 if t > run.t_open else t, k)
                    for t, k in s.deliveries]
    assert val("itl_p95_ms", run) > 10.0


def test_ttft_over_requests_sent_in_window():
    run = synthetic()
    assert val("ttft_p95_ms", run) is None        # none sent in the window
    st = SimpleNamespace(tokens=[0], t_first_token=run.t_open + 0.2,
                         t_admitted=run.t_open + 0.15, status="decode",
                         finish_reason=None)
    run.requests[99] = Served(99, 0, np.zeros(8, np.int32), 10,
                              run.t_open + 0.1, st, [], 0)
    assert val("ttft_p95_ms", run) == pytest.approx(100.0)


@pytest.mark.parametrize("name", ["admit_share", "step_mfu"])
def test_shares_stay_within_100(name):
    for run in (synthetic(), synthetic(stall=0.5)):
        v = val(name, run)
        assert v is not None and 0.0 <= v <= 100.0


def test_activated_experts_is_the_counter_mean():
    assert val("activated_experts", synthetic()) == 20.0


def test_device_metrics_need_a_trace():
    run = synthetic()
    assert val("device_idle_share", run) is None
    assert val("expert_ffn_roofline", run) is None
    t0, t1 = run.t_open, run.t_close
    run.trace_open, run.trace_close, run.rounds_before_trace = t0, t1, 10
    run.trace = {"device": [("void moe_up_kernel<1>(int)", t0, t0 + 0.001,
                             True),
                            ("elementwise", t0 + 0.5 * (t1 - t0), t1, False)],
                 "graph_launches": [], "marks": []}
    assert val("device_idle_share", run) == pytest.approx(
        100 * (1 - (0.001 + 0.5 * (t1 - t0)) / (t1 - t0)))
    assert val("expert_ffn_roofline", run) > 0
