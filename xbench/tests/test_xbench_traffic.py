"""The traffic generator: the same seed gives the same requests, every
seed the same sizes, all inside the mix's bounds."""
import numpy as np
import pytest

from xbench_tiny import BENCH, CELLS

from xbench import traffic

MIXES = sorted({BENCH.cell(c)["traffic"] for c in CELLS})


def small(mix_name):
    mix = BENCH.mix({"traffic": mix_name})
    mix["table"] = 64
    return mix


@pytest.mark.parametrize("name", MIXES)
def test_deterministic_and_bounded(name):
    mix = small(name)
    a = traffic.make_table(mix, 4096, 2**31 + 11)
    b = traffic.make_table(mix, 4096, 2**31 + 11)
    c = traffic.make_table(mix, 4096, 7)
    assert all(np.array_equal(x.prompt, y.prompt) and
               x.answer_len == y.answer_len for x, y in zip(a, b))
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))
    lo, hi = mix["prompt_len"]
    alo, ahi = mix["answer_len"]
    for r in a + c:
        assert lo <= len(r.prompt) <= hi and alo <= r.answer_len <= ahi
        assert r.prompt.dtype == np.int32 and (r.prompt < 4096).all()
    # every seed serves the same sizes, in another order
    sizes = lambda t: sorted((len(r.prompt), r.answer_len) for r in t)
    assert sizes(a) == sizes(c)
    traffic.check_mix(mix, mix["cache_len"])


def test_log_uniform_quantiles():
    q = traffic.log_uniform_quantiles(64, 1024, 1000)
    assert q.min() >= 64 and q.max() <= 1024
    assert abs(np.median(q) - 256) <= 2        # the log midpoint


def test_clients_take_distinct_entries():
    table = list(range(10))
    got = [traffic.client_request(table, 3, c, k)
           for k in range(3) for c in range(3)]
    assert got == list(range(9))


def test_mix_that_overflows_its_cache_is_refused():
    mix = small(MIXES[0])
    with pytest.raises(ValueError):
        traffic.check_mix(mix, mix["prompt_len"][1])
