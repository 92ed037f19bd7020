"""The port's ``FusionPolicy`` and the engine's choice of K against the JAX package's, on the CPU.

- ``FusionPolicy.choose_k`` equals ``repro.core.policy.FusionPolicy``'s at
  every point of a grid: foreign queue depth x mean remaining length x
  observed foreign wait x feedback on and off, under several policies; the
  same inputs are refused with the same errors, and ``of()`` builds the
  same policies.
- ``ServeEngine._observed_foreign_wait`` equals the JAX engine's on the
  ledgers of ``tests/test_feedback_fusion.py``: a foreign tenant's virtual
  waits on a shared scheduler, stale producers aging out after
  ``FEEDBACK_STALE_LAUNCHES`` launches, and the queue's ledger read beside
  an explicit one.
- A feedback engine fed slow foreign waits spends more decode launches (a
  smaller K) than a clean one, with identical streams; the port's launches
  equal the JAX engine's in both runs.

Everything here is exact: integers and the ledgers' own quantiles.
"""

from __future__ import annotations

import itertools

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import ledger as jledger
from repro.core import policy as jpolicy
from repro.core.hsa.clock import VirtualClock as JVirtualClock
from repro.core.hsa.queue import Queue as JQueue
from repro.core.hsa.scheduler import Scheduler as JScheduler
from repro.core.reconfig import RegionManager as JRegionManager
from repro.core.roles import RoleLibrary as JRoleLibrary
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import hsa as thsa
from repro_torch.core import ledger as tledger
from repro_torch.core import policy as tpolicy
from repro_torch.core.reconfig import RegionManager
from repro_torch.core.roles import RoleLibrary
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve.engine import ServeEngine

POLICY_ARGS = [
    dict(),
    dict(max_fusion=8),
    dict(max_fusion=8, feedback=True, target_wait_s=1e-3),
    dict(max_fusion=16, min_fusion=2, fairness_depth=4),
    dict(max_fusion=8, min_fusion=3, feedback=True, target_wait_s=2e-3, fairness_depth=1),
    dict(max_fusion=6, fairness_depth=0),
    dict(max_fusion=1),
]
DEPTHS = (0, 1, 3, 8, 16, 40, 10_000)
LENGTHS = (0.0, 0.5, 1.0, 2.9, 5.0, 7.5, 100.0)
WAITS = (None, 0.0, 0.5e-3, 1e-3, 2e-3, 4.1e-3, 64e-3, 1.0)


@pytest.mark.parametrize("args", POLICY_ARGS, ids=lambda a: ",".join(f"{k}={v}" for k, v in
                                                                      a.items()) or "default")
def test_choose_k_equals_jax_on_the_grid(args):
    jpol, tpol = jpolicy.FusionPolicy(**args), tpolicy.FusionPolicy(**args)
    assert tpol == tpolicy.FusionPolicy(**vars(jpol))
    for depth, length, wait in itertools.product(DEPTHS, LENGTHS, WAITS):
        kw = dict(queue_depth=depth, mean_request_len=length, observed_wait_s=wait)
        assert tpol.choose_k(**kw) == jpol.choose_k(**kw), kw


@pytest.mark.parametrize("bad", [dict(min_fusion=0), dict(max_fusion=2, min_fusion=3),
                                 dict(fairness_depth=-1), dict(target_wait_s=0.0)])
def test_validation_errors_equal_jax(bad):
    with pytest.raises(ValueError) as jerr:
        jpolicy.FusionPolicy(**bad)
    with pytest.raises(ValueError) as terr:
        tpolicy.FusionPolicy(**bad)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("value", [None, 1, 4, 7])
def test_of_equals_jax(value):
    assert vars(tpolicy.FusionPolicy.of(value)) == vars(jpolicy.FusionPolicy.of(value))
    pol = tpolicy.FusionPolicy(max_fusion=8)
    assert tpolicy.FusionPolicy.of(pol) is pol


# ---------------------------------------------------------------------------
# the engine's contention signal, on both packages' ledgers
# ---------------------------------------------------------------------------


def _probes(jled, tled):
    """Both engines' shells with exactly the state _observed_foreign_wait
    reads (no model built)."""
    jprobe = JServeEngine.__new__(JServeEngine)
    tprobe = ServeEngine.__new__(ServeEngine)
    for probe, led in ((jprobe, jled), (tprobe, tled)):
        probe._producer = "tf-serving"
        probe._hsa_queue = None
        probe.ledger = led
        probe._wait_freshness = {}
    return jprobe, tprobe


def _foreign_rounds(sched, queue, ledger, clock, cost_s, wait_cat, rounds=32):
    """A foreign tenant's packets, each waited for on the virtual timeline."""
    for _ in range(rounds):
        t0 = clock.now()
        pkt = queue.call(lambda: None, producer="opencl")
        sched.drain(queue)
        pkt.completion.wait_eq(0)
        ledger.record(wait_cat, pkt.completion._complete_t - t0, queue=queue.name,
                      producer="opencl", virtual=True)


@pytest.mark.parametrize("cost_s", [16e-3, 1e-3, 0.01e-3])
def test_observed_foreign_wait_equals_jax_on_virtual_waits(cost_s):
    costs = lambda kind, what, measured: cost_s if kind == "exec" else 0.0  # noqa: E731
    jled, tled = jledger.OverheadLedger(), tledger.OverheadLedger()
    jclock, tclock = JVirtualClock(), thsa.VirtualClock()
    jsched = JScheduler(JRegionManager(2, ledger=jled), JRoleLibrary(ledger=jled), ledger=jled,
                        clock=jclock, cost_model=costs)
    tsched = thsa.Scheduler(RegionManager(2, ledger=tled), RoleLibrary(ledger=tled),
                            ledger=tled, clock=tclock, cost_model=costs)
    jq = jsched.add_queue(JQueue(None, 256, name="shared"))
    tq = tsched.add_queue(thsa.Queue(None, 256, name="shared"))
    _foreign_rounds(jsched, jq, jled, jclock, cost_s, jledger.DISPATCH_WAIT)
    _foreign_rounds(tsched, tq, tled, tclock, cost_s, tledger.DISPATCH_WAIT)
    jprobe, tprobe = _probes(jled, tled)
    want = JServeEngine._observed_foreign_wait(jprobe)
    assert want == pytest.approx(32 * cost_s)
    assert ServeEngine._observed_foreign_wait(tprobe) == want
    pol = (jpolicy.FusionPolicy(max_fusion=8, feedback=True, target_wait_s=1e-3),
           tpolicy.FusionPolicy(max_fusion=8, feedback=True, target_wait_s=1e-3))
    assert pol[1].choose_k(observed_wait_s=want) == pol[0].choose_k(observed_wait_s=want)


def test_stale_foreign_waits_age_out_as_jax_does():
    jled, tled = jledger.OverheadLedger(), tledger.OverheadLedger()
    for led, cat in ((jled, jledger.DISPATCH_WAIT), (tled, tledger.DISPATCH_WAIT)):
        for _ in range(64):
            led.record(cat, 20e-3, producer="opencl")
        led.record(cat, 1e-3, producer="tf-serving")      # its own waits never count
    jprobe, tprobe = _probes(jled, tled)
    assert ServeEngine.FEEDBACK_STALE_LAUNCHES == JServeEngine.FEEDBACK_STALE_LAUNCHES
    seq = []
    for i in range(ServeEngine.FEEDBACK_STALE_LAUNCHES + 3):
        if i == ServeEngine.FEEDBACK_STALE_LAUNCHES + 1:   # fresh activity revives it
            jled.record(jledger.DISPATCH_WAIT, 30e-3, producer="opencl")
            tled.record(tledger.DISPATCH_WAIT, 30e-3, producer="opencl")
        got = ServeEngine._observed_foreign_wait(tprobe)
        assert got == JServeEngine._observed_foreign_wait(jprobe)
        seq.append(got)
    assert seq[0] == pytest.approx(20e-3) and seq[ServeEngine.FEEDBACK_STALE_LAUNCHES] is None
    assert seq[-1] == pytest.approx(30e-3)
    assert tprobe._wait_freshness == jprobe._wait_freshness


def test_contention_is_read_from_the_queue_ledger_beside_an_explicit_one():
    jq_led, tq_led = jledger.OverheadLedger(), tledger.OverheadLedger()
    for _ in range(16):
        jq_led.record(jledger.DISPATCH_WAIT, 5e-3, producer="opencl")
        tq_led.record(tledger.DISPATCH_WAIT, 5e-3, producer="opencl")
    jprobe, tprobe = _probes(jledger.OverheadLedger(), tledger.OverheadLedger())
    jprobe._hsa_queue = type("Q", (), {"ledger": jq_led})()
    tprobe._hsa_queue = type("Q", (), {"ledger": tq_led})()
    want = JServeEngine._observed_foreign_wait(jprobe)
    assert want == pytest.approx(5e-3)
    assert ServeEngine._observed_foreign_wait(tprobe) == want


# ---------------------------------------------------------------------------
# a feedback engine end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jmodel = jbuild_model(jreduced(JARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128))
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(11))
    model = build_model(reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128),
                        device="cpu")
    return jmodel, jparams, model, params_from_jax(jax.tree.map(np.asarray, jparams),
                                                   device="cpu")


def _feedback_run(cls, model, params, ledger_mod, pol_mod, congested, **kw):
    led = ledger_mod.OverheadLedger()
    if congested:
        for _ in range(64):
            led.record(ledger_mod.DISPATCH_WAIT, 20e-3, producer="opencl")
    eng = cls(model, params, batch_slots=1, max_len=32, ledger=led,
              decode_fusion=pol_mod.FusionPolicy(max_fusion=8, feedback=True,
                                                 target_wait_s=1e-3), **kw)
    launches = 0
    orig = eng._launch

    def counting(*a, **k):
        nonlocal launches
        launches += 1
        return orig(*a, **k)

    eng._launch = counting
    eng.submit([5, 6, 7], max_new_tokens=8)
    (req,) = eng.run_to_completion()
    return req.generated, launches


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_feedback_engine_spends_more_launches_with_identical_streams(models, temperature):
    jmodel, jparams, model, params = models
    runs = {}
    for congested in (False, True):
        runs[congested] = _feedback_run(ServeEngine, model, params, tledger, tpolicy,
                                        congested, device="cpu", temperature=temperature,
                                        seed=3)
        want = _feedback_run(JServeEngine, jmodel, jparams, jledger, jpolicy, congested,
                             temperature=temperature, seed=3)
        assert runs[congested] == want
    assert runs[True][0] == runs[False][0]
    # calm: one prefill and one K = 8 launch; congested: K = 1, eight launches
    assert runs[True][1] > runs[False][1]
