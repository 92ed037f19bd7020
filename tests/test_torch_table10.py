"""Table X (self-healing serving under injected faults) on the port against
the JAX package's ``benchmarks/table10_faults.py``, on the CPU.

``run_once``, the paged engine routed through a virtual-clock scheduler
under the seeded plan, on the same weights (the JAX script's tiny llama,
``params_from_jax``) and the same requests (n = 16), both packages under
the ``reference`` pair: goodput, makespan and ``availability_split()``
equal to the last digit, and each faulted run's streams its own fault-free
run's.  Across the packages the streams are equal where the two fault-free
runs agree: two of the 16 part at a near-tie of the bf16 residual rounding
(requests 3 and 6, at their 8th and 12th tokens; ROADMAP §3), which no
count of the schedule sees.  Then the tenant arm's load faults and
retries, and ``EXPECTED`` against ``BENCH_results.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from benchmarks import table10_faults as jtable10
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import dispatch as jdispatch
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro_torch.bench import table10_faults as table10
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.models import build_model, params_from_jax

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jmodel = jbuild_model(jreduced(JARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128))
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(0))
    m = build_model(reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128), device="cpu")
    return jmodel, jparams, m, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def clean(models):
    """The fault-free run of 16 requests through both packages."""
    jmodel, jparams, m, p = models
    reqs = table10.make_requests(16)
    with dispatch.use(prefer=("reference",)):
        got = table10.run_once(m, p, reqs)
    with jdispatch.use(prefer=("reference",)):
        want = jtable10.run_once(jmodel, jparams, reqs)
    return got, want


def test_requests_plans_and_constants_equal_the_jax_benchmark():
    assert table10.make_requests(48) == jtable10.make_requests(48)
    for name in ("SLOTS", "MAX_LEN", "PAGE", "FUSION", "SEED", "EXEC_S", "RECONFIG_S", "RATES",
                 "GOODPUT_FLOOR"):
        assert getattr(table10, name) == getattr(jtable10, name), name
    for rate in table10.RATES:
        a, b = table10.make_plan(rate), jtable10.make_plan(rate)
        assert (a.seed, a.exec_rate, a.wedge_rate) == (b.seed, b.exec_rate, b.wedge_rate)
    for kind in ("reconfig", "exec", "wedge"):
        assert table10.cost(kind, "x", 9.0) == jtable10._cost(kind, "x", 9.0)


def agreeing(got: dict, want: dict) -> list[int]:
    """The requests whose streams the two packages' fault-free runs agree on."""
    return [u for u in got if got[u] == want[u]]


def test_fault_free_run_equals_the_jax_benchmark(clean):
    got, want = clean
    assert ({k: v for k, v in got.items() if k != "streams"}
            == {**{k: v for k, v in want.items() if k != "streams"},
                "avail": {k: float(v) for k, v in want["avail"].items()}})
    assert got["completed"] == 16
    assert agreeing(got["streams"], want["streams"]) == [u for u in range(1, 17)
                                                         if u not in (3, 6)]


@pytest.mark.parametrize("policy", ["sched", "engine"])
@pytest.mark.parametrize("rate", [0.05, 0.10])
def test_faulted_run_equals_the_jax_benchmark(models, clean, rate, policy):
    """One rate under one recovery policy: goodput, makespan, the
    availability split and the injected count exactly; the streams the
    fault-free run's in each package, and the JAX engine's."""
    jmodel, jparams, m, p = models
    reqs = table10.make_requests(16)
    with dispatch.use(prefer=("reference",)):
        got = table10.run_once(m, p, reqs, plan=table10.make_plan(rate),
                               **table10.POLICIES[policy])
    with jdispatch.use(prefer=("reference",)):
        want = jtable10.run_once(jmodel, jparams, reqs, plan=jtable10.make_plan(rate),
                                 **jtable10.POLICIES[policy])
    assert got["avail"] == {k: float(v) for k, v in want["avail"].items()}
    assert (got["makespan"], got["goodput"], got["injected"], got["completed"]) == (
        want["makespan"], want["goodput"], want["injected"], want["completed"])
    assert got["injected"] > 0
    assert got["streams"] == clean[0]["streams"]
    assert want["streams"] == clean[1]["streams"]


def test_tenant_arm_equals_the_jax_benchmark(models):
    """Three forced region-load faults beside the engine: retried, no
    tenant packet failed, the streams the fault-free run's."""
    jmodel, jparams, m, p = models
    reqs = table10.make_requests(16)
    with dispatch.use(prefer=("reference",)):
        got = table10.run_tenant_arm(m, p, reqs)
    with jdispatch.use(prefer=("reference",)):
        want = jtable10.run_tenant_arm(jmodel, jparams, reqs)
    assert got == {**want, "load_faults": float(want["load_faults"]),
                   "retries": float(want["retries"])}
    assert got["load_faults"] == 3 and got["streams_ok"]


def test_expected_is_bench_results():
    """``EXPECTED`` is ``BENCH_results.json``'s Table X at the JAX script's
    rounding (the full n = 48 sweep on the port runs in the harness test)."""
    rows = json.loads((ROOT / "BENCH_results.json").read_text())["rows"]
    bench = {r["metric"]: (r["value"], r["derived"]) for r in rows if r["table"] == "table10"}
    assert set(bench) == set(table10.EXPECTED)
    for metric, (value, derived) in table10.EXPECTED.items():
        assert (float(value), derived) == bench[metric], metric
