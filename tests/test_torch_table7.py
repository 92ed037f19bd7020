"""Table VII (the paged KV cache) on the port against the JAX package's
``benchmarks/table7_paged.py``, on the CPU.

The trace arm (``request_mix``, ``simulate_dense``, ``simulate_paged``) on the
same inputs as the JAX script's, every number equal, and the rows against
``BENCH_results.json`` (``EXPECTED``).  The serve arm on the JAX script's
tiny llama (``jax.random.key(0)``, copied into the port with
``params_from_jax``), both packages under the ``reference`` policy pair:
the concurrency, the ledger's ``memory_split()`` and the streams equal.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from benchmarks import table7_paged as jtable7
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import dispatch as jdispatch
from repro.core import policy as jpolicy
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro_torch.bench import common
from repro_torch.bench import table7_paged as table7
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.core import policy as tpolicy
from repro_torch.models import build_model, params_from_jax

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny model's ops gain nothing from threads, and their spinning
    slows the other test workers: one thread while this file runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    """The JAX scripts' tiny llama (``jax.random.key(0)``) in the port."""
    jmodel = jbuild_model(jreduced(JARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128))
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(0))
    m = build_model(reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128), device="cpu")
    return m, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def bench_rows(table: str) -> dict:
    """``BENCH_results.json``'s rows of ``table``: metric -> (value, derived)."""
    rows = json.loads((ROOT / "BENCH_results.json").read_text())["rows"]
    return {r["metric"]: (r["value"], r["derived"]) for r in rows if r["table"] == table}


@pytest.mark.parametrize("n", [32, 64, 100])
def test_request_mix_equals_the_jax_benchmark(n):
    assert table7.request_mix(n) == jtable7.request_mix(n)
    assert table7.request_mix(n, seed=3) == jtable7.request_mix(n, seed=3)


@pytest.mark.parametrize("pool", table7.POOL_SWEEP)
def test_simulate_dense_equals_the_jax_benchmark(pool):
    reqs = table7.request_mix(64)
    assert table7.simulate_dense(reqs, pool) == jtable7.simulate_dense(reqs, pool)


@pytest.mark.parametrize("pool", table7.POOL_SWEEP)
@pytest.mark.parametrize("page_size", table7.PAGE_SWEEP)
def test_simulate_paged_equals_the_jax_benchmark(page_size, pool):
    reqs = table7.request_mix(64)
    got = table7.simulate_paged(reqs, pool, page_size, tpolicy.AdmissionPolicy())
    want = jtable7.simulate_paged(reqs, pool, page_size, jpolicy.AdmissionPolicy())
    assert got == want


def test_constants_equal_the_jax_benchmark():
    assert (table7.MAX_LEN, table7.PAGE_SWEEP, table7.POOL_SWEEP) == (
        jtable7.MAX_LEN, jtable7.PAGE_SWEEP, jtable7.POOL_SWEEP)


def test_trace_rows_equal_bench_results():
    """Every trace row, value and derived, is ``EXPECTED``, and ``EXPECTED``
    is ``BENCH_results.json``'s (the values at the JAX script's rounding)."""
    got = table7.trace_rows(64)
    table7.check(got)
    bench = bench_rows("table7")
    for metric, (value, derived) in table7.EXPECTED.items():
        assert float(value) == bench[metric][0] and derived == bench[metric][1], metric


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_serve_arm_equals_the_jax_benchmark(model, paged):
    """``run_serving`` against the JAX script's ``_run_serving`` at its
    8 requests of 9 tokens: concurrency, ``memory_split()`` and streams."""
    m, p = model
    with dispatch.use(prefer=("reference",)):
        got = table7.run_serving(m, p, paged, 8, 9)
    with jdispatch.use(prefer=("reference",)):
        want = jtable7._run_serving(paged, 8, 9)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == {k: float(v) for k, v in want[2].items()}


def test_serve_rows_hold_expected_and_asserted(model):
    """The serve arm's rows on the tiny llama: the concurrency row is
    ``EXPECTED``'s, the asserted rows read 1, and with every row present
    ``check(complete=True)`` passes; a row left out fails it."""
    m, p = model
    with dispatch.use(prefer=("reference",)):
        got = table7.rows(64, model=m, params=p)
    table7.check(got, complete=True)
    assert got["serve_paged_memory"][0] == "1.00"
    with pytest.raises(AssertionError, match="serve_paged_wins"):
        table7.check({k: v for k, v in got.items() if k != "serve_paged_wins"}, complete=True)
    with pytest.raises(AssertionError, match="must read 1"):
        table7.check({**got, "serve_paged_identical": ("0", "")})


def test_serve_model_and_kv_scale():
    """The CPU's serve model is the tiny llama (128 KV bytes a position);
    the full llama3.2-1b holds 256 times that (built on meta tensors)."""
    m, _ = common.serve_model("cpu")
    assert (m.cfg.num_layers, m.cfg.d_model, m.cfg.vocab_size) == (2, 64, 128)
    assert common.kv_token_bytes(m) == common.TINY_TOKEN_BYTES
    assert common.kv_scale(m) == 1
    full = build_model(ARCHS["llama3.2-1b"], device="meta")
    assert common.kv_scale(full) == 256
