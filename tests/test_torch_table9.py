"""Table IX's trace arm on the port against the JAX package's, on the CPU.

``repro_torch.bench.table9_traffic`` is the port's copy of the trace arm of
``benchmarks/table9_traffic.py``: its constants, step time model and
fixed-seed traces must be the JAX script's, and its ``replay`` of each
trace (n = 16; bursty is 128 requests at any n), chunked and whole, must
give the JAX script's numbers on the same weights (``params_from_jax``,
the reduced ``llama3.2-1b`` of ``tests/test_traffic.py``): TTFT and TPOT
quantiles, requests, makespan and throughput are properties of the
schedule.  A file of its own beside ``tests/test_torch_traffic.py``: the
bursty trace's replays are the slowest cases.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from benchmarks import table9_traffic as jtable9
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro_torch.bench import table9_traffic as table9
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import build_model, params_from_jax


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny model's ops gain nothing from threads, and their spinning
    slows the other test workers: one thread while this file runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(JARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128)
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(11))
    model = build_model(reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128),
                        device="cpu")
    return jmodel, jparams, model, params_from_jax(jax.tree.map(np.asarray, jparams),
                                                   device="cpu")


@pytest.mark.parametrize("name", ["poisson", "bursty", "longtail"])
def test_table9_replay_equals_the_jax_benchmark(models, name):
    """``repro_torch.bench.table9_traffic.replay`` against the JAX script's
    ``replay`` on the same trace (n = 16; bursty is 128 requests at any n),
    chunked and whole: every number of the two dicts equal (TTFT and TPOT
    quantiles, requests, makespan, throughput: the schedule's), and each
    engine's chunked streams equal its own whole-prompt streams.  The two
    packages' streams themselves are not compared here: over 16 tokens of
    a random model they part at near-ties under either policy pair (ROADMAP
    §3, known differences)."""
    jmodel, jparams, model, params = models
    trace = table9.make_traces(16)[name]
    assert trace == jtable9.make_traces(16)[name]
    streams = {}
    for chunk in (table9.CHUNK, None):
        got = table9.replay(model, params, trace, chunk=chunk)
        want = jtable9.replay(jmodel, jparams, trace, chunk=chunk)
        streams[chunk] = got.pop("streams"), want.pop("streams")
        assert got == want, chunk
        assert got["requests"] == len(trace)
    assert streams[table9.CHUNK] == streams[None]


def test_table9_constants_and_step_time_equal_the_jax_benchmark():
    for name in ("SLOTS", "MAX_LEN", "CHUNK", "FUSION", "MAX_NEW", "BASE_S", "PREFILL_S",
                 "DECODE_S", "SLO_TTFT_P99_S", "SLO_TPOT_P99_S", "LONG_PROMPT"):
        assert getattr(table9, name) == getattr(jtable9, name), name
    for p, d in ((0, 0), (16, 24), (256, 0), (7, 13)):
        assert table9.step_time(p, d) == jtable9.step_time(p, d)
    assert table9.make_traces(64) == jtable9.make_traces(64)


def test_table9_rows_are_run_rows_for_the_harness(models, monkeypatch):
    """``rows`` gives :func:`run`'s CSV rows as metric -> (value, derived),
    the form every other table gives the harness, at the ``n`` asked for;
    the derived field keeps its commas."""
    _, _, model, params = models
    asked = []

    def fake_run(m, p, n):
        asked.append(n)
        return ["table9,ttft_p99_us_bursty_chunked,8400,ttft_p50_us=1;a,b",
                "table9,chunked_wins,1,ttft_p99_ratio=2.50"], {}

    monkeypatch.setattr(table9, "run", fake_run)
    got = table9.rows(16, model=model, params=params)
    assert asked == [16]
    assert got == {"ttft_p99_us_bursty_chunked": ("8400", "ttft_p50_us=1;a,b"),
                   "chunked_wins": ("1", "ttft_p99_ratio=2.50")}
