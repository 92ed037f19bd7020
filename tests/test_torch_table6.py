"""Table VI (fused decode x burst submission) on the port against the JAX
package's ``benchmarks/table6_dispatch.py``, on the CPU.

The trace arm's chained decode packets at every fusion depth and burst:
the ledger's packet counts and the scheduler's virtual timeline equal the
JAX script's (the dispatch legs are host seconds: not compared).  The serve
arm on the JAX script's tiny llama (``jax.random.key(0)`` in the port by
``params_from_jax``), both under the ``reference`` pair: the packets (20 at
K = 1, 10 at K = 4) and the streams equal.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from benchmarks import table6_dispatch as jtable6
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import dispatch as jdispatch
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro_torch.bench import table6_dispatch as table6
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.models import build_model, params_from_jax

#: the dispatch split's counts (its seconds are the host's)
COUNTS = ("submit_n", "grant_n", "wait_n")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
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


def test_constants_equal_the_jax_benchmark():
    assert (table6.FUSION_SWEEP, table6.BURST_SWEEP) == (jtable6.FUSION_SWEEP,
                                                         jtable6.BURST_SWEEP)


@pytest.mark.parametrize("burst", [1, 8])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_trace_counts_equal_the_jax_benchmark(k, burst):
    """At n = 64 (and at 37, where the last launch is partial), every
    category's record count equals the JAX script's ledger's."""
    for ntokens in (64, 37):
        got = table6.run_trace(ntokens, k, burst, 2.5e-4)
        want = jtable6._run_trace(ntokens, k, burst, 2.5e-4)
        gs, ws = got.dispatch_split(), want.dispatch_split()
        assert {c: gs[c] for c in COUNTS} == {c: ws[c] for c in COUNTS}
        assert ({cat: got.stat(cat).count for cat in ("exec", "dispatch", "wait")}
                == {cat: want.stat(cat).count for cat in ("exec", "dispatch", "wait")})
        if ntokens == 64:
            assert gs["submit_n"] == table6.EXPECTED_COUNTS[(k, burst)]["packets"]


@pytest.mark.parametrize("k", [1, 4])
def test_serve_arm_equals_the_jax_benchmark(model, k):
    """``run_serving`` against the JAX script's ``_run_serving`` (8 new
    tokens, after the warm-up request): the packets and the streams."""
    m, p = model
    with dispatch.use(prefer=("reference",)):
        _, streams, packets = table6.run_serving(m, p, 8, k)
    with jdispatch.use(prefer=("reference",)):
        _, jstreams, jpackets = jtable6._run_serving(8, k)
    assert packets == jpackets == {1: 20, 4: 10}[k]
    assert streams == jstreams


def test_rows_hold_the_counts_and_the_serve_rows(model):
    """``rows`` at a fixed per-token exec: every trace cell's packets and
    tokens are ``EXPECTED_COUNTS``' and the serve rows ``EXPECTED``'s (their
    derived counts; the µs are the host's)."""
    m, p = model
    with dispatch.use(prefer=("reference",)):
        got = table6.rows(64, model=m, params=p, exec_tok_s=2.5e-4)
    for (k, b), want in table6.EXPECTED_COUNTS.items():
        assert got[f"dispatch_per_token_k{k}_b{b}"][1].endswith(
            f"packets={want['packets']};tokens={want['tokens']}")
    table6.check(got, complete=False)
    assert got["serve_fused_identical"] == ("1", "k1_packets=20;k4_packets=10")
    with pytest.raises(AssertionError, match="serve_dispatch_per_token_k4"):
        table6.check({**got, "serve_dispatch_per_token_k4": ("1.0", "packets=11;"
                                                             "identical_streams=1")})
