"""The port's ``ServeEngine`` routed through an HSA queue, against the JAX
engine, on the CPU.

- Routed through a queue and the async scheduler (cooperative drain on a
  ``VirtualClock``), the port's greedy streams equal the JAX routed
  engine's token for token, under both policy pairs of
  ``tests/test_torch_model.py``, dense and paged, fusion 1 and 4; the queue
  carries the same packets (prefill, fixup, fused decode, by name) in the
  same order.
- With the scheduler's worker thread running, and beside a second queue of
  conv packets (``examples/serve_lm.py``'s sensor-fusion tenant), the
  streams still equal the JAX engine's, and every conv packet equals its
  plain version.
- The engine records ``DISPATCH_WAIT`` per launch, and its reserved/used KV
  bytes (``record_memory``) equal the JAX engine's, dense and paged.
- A packet whose call raises re-raises from ``step()``, drained or threaded.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import dispatch as jdispatch
from repro.core import hsa as jhsa
from repro.core import ledger as jledger
from repro.core.reconfig import RegionManager as JRegionManager
from repro.core.roles import RoleLibrary as JRoleLibrary
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.core import hsa as thsa
from repro_torch.core import ledger as tledger
from repro_torch.core.reconfig import RegionManager
from repro_torch.core.registry import FIXED_WEIGHT, KernelImpl
from repro_torch.core.roles import ArgSpec, RoleLibrary
from repro_torch.kernels import conv2d as conv_k
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve.engine import ServeEngine

PROMPTS = [[3, 14, 15, 92], [7, 8], [1, 2, 3, 4, 5, 6], [42]]
POLICIES = {
    "reference": (("reference",), ("reference",)),
    "default": (("xla", "reference"), ("torch", "reference")),
}


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(JARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128)
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(11))
    cfg = reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128)
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, model, params


def _streams(engine, max_new: int = 7) -> list[list[int]]:
    for p in PROMPTS:
        engine.submit(p, max_new_tokens=max_new)
    return [r.generated for r in sorted(engine.run_to_completion(), key=lambda r: r.uid)]


def _sched(hsa, regions_cls, lib_cls, ledger, clock):
    sched = hsa.Scheduler(regions_cls(2, ledger=ledger), lib_cls(ledger=ledger), ledger=ledger,
                          clock=clock)
    return sched, sched.add_queue(hsa.Queue(None, 256, name="tf-serving"))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("fusion", [1, 4])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_routed_streams_and_packets_match_jax(models, policy, fusion, paged):
    jmodel, jparams, model, params = models
    jprefer, tprefer = POLICIES[policy]
    kw = dict(batch_slots=2, max_len=32, decode_fusion=fusion, paged=paged, page_size=8)
    jled = jledger.OverheadLedger()
    jsched, jq = _sched(jhsa, JRegionManager, JRoleLibrary, jled, jhsa.VirtualClock())
    with jdispatch.use(prefer=jprefer):
        want = _streams(JServeEngine(jmodel, jparams, hsa_queue=jq, hsa_scheduler=jsched, **kw))
    tled = tledger.OverheadLedger()
    tsched, tq = _sched(thsa, RegionManager, RoleLibrary, tled, thsa.VirtualClock())
    with dispatch.use(prefer=tprefer):
        got = _streams(ServeEngine(model, params, hsa_queue=tq, hsa_scheduler=tsched,
                                   device="cpu", **kw))
    assert got == want
    packets = [(e.kind, e.queue, e.what) for e in tsched.event_log()]
    assert packets == [(e.kind, e.queue, e.what) for e in jsched.event_log()]
    assert tsched.queue_report()["tf-serving"]["dispatched"] == \
        jsched.queue_report()["tf-serving"]["dispatched"]
    # one DISPATCH_WAIT a launch, as many as the packets the queue carried
    assert tled.stat(tledger.DISPATCH_WAIT).count == jled.stat(jledger.DISPATCH_WAIT).count \
        == tsched.queue_report()["tf-serving"]["dispatched"]
    assert tled.queue_breakdown()["tf-serving"]["wait"].count == \
        tled.stat(tledger.DISPATCH_WAIT).count


def _conv_role(lib, device="cpu"):
    w = torch.ones((3, 3, 1, 1), dtype=torch.int16)
    impl = KernelImpl(op="sensor_conv", device_kind="any", source="cuda",
                      fn=conv_k.conv2d_fixed_weight(w), specialization=FIXED_WEIGHT)
    return lib.make_role(impl, (ArgSpec((1, 32, 32, 1), torch.int16),), name="sensor_conv",
                         device=device), w


@pytest.mark.parametrize("with_tenant", [False, True], ids=["alone", "beside_conv_tenant"])
def test_threaded_scheduler_streams_match_jax(models, with_tenant):
    """The scheduler's worker thread consumes both queues; the engine waits
    on each packet's completion.  Default policy on both sides (the packet
    carries the engine thread's dispatch context to the worker)."""
    jmodel, jparams, model, params = models
    with jdispatch.use(prefer=POLICIES["default"][0]):
        want = _streams(JServeEngine(jmodel, jparams, batch_slots=2, max_len=32,
                                     decode_fusion=4))
    ledger = tledger.OverheadLedger()
    sys_ = thsa.HsaSystem(num_regions=2, ledger=ledger, device="cpu")
    agent = sys_.default_agent
    sched = sys_.scheduler_of(agent)
    q_tf = sys_.create_queue(agent, name="tf-serving")
    q_cl = sys_.create_queue(agent, name="opencl")
    role, w = _conv_role(sys_.library)
    sys_.library.synthesize_all()
    sched.start()
    try:
        with dispatch.use(prefer=POLICIES["default"][1]):
            eng = ServeEngine(model, params, batch_slots=2, max_len=32, decode_fusion=4,
                              hsa_queue=q_tf, hsa_scheduler=sched, device="cpu")
            for p in PROMPTS:
                eng.submit(p, max_new_tokens=7)
            rng = np.random.default_rng(0)
            done, frames = [], []
            for _ in range(100):
                if with_tenant:
                    x = torch.tensor(rng.integers(-99, 99, (1, 32, 32, 1)), dtype=torch.int16)
                    frames.append((x, q_cl.dispatch(role.key, x, producer="opencl")))
                done += eng.step()
                if len(done) == len(PROMPTS):
                    break
        for x, pkt in frames:
            assert pkt.completion.wait_eq(0, timeout=30)
            assert pkt.out.error is None
            assert torch.equal(pkt.out.value, conv_k.plain_conv2d(x, w))
    finally:
        sys_.shutdown()
    got = [r.generated for r in sorted(done, key=lambda r: r.uid)]
    assert got == want
    rep = sched.queue_report()
    assert rep["tf-serving"]["dispatched"] >= len(PROMPTS) + 2
    assert rep["opencl"]["dispatched"] == len(frames)
    assert ledger.stat(tledger.DISPATCH_WAIT).count == rep["tf-serving"]["dispatched"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_record_memory_matches_jax(models, paged):
    jmodel, jparams, model, params = models
    kw = dict(batch_slots=2, max_len=32, decode_fusion=1, paged=paged, page_size=8)
    jled, tled = jledger.OverheadLedger(), tledger.OverheadLedger()
    with jdispatch.use(prefer=POLICIES["default"][0]):
        want_streams = _streams(JServeEngine(jmodel, jparams, ledger=jled, **kw))
    with dispatch.use(prefer=POLICIES["default"][1]):
        got_streams = _streams(ServeEngine(model, params, ledger=tled, device="cpu", **kw))
    assert got_streams == want_streams
    keys = ("reserved_bytes", "used_bytes", "stranded_bytes", "peak_reserved_bytes",
            "peak_stranded_bytes", "samples", "utilization")
    want, got = jled.memory_split(), tled.memory_split()
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["samples"] > 0 and got["peak_reserved_bytes"] > 0
    assert tled.stat(tledger.TTFT).count == jled.stat(jledger.TTFT).count == len(PROMPTS)


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("threaded", [False, True], ids=["drain", "worker"])
def test_packet_error_reraises_from_step(models, threaded):
    _, _, model, params = models
    ledger = tledger.OverheadLedger()
    clock = thsa.WallClock() if threaded else thsa.VirtualClock()
    sched, q = _sched(thsa, RegionManager, RoleLibrary, ledger, clock)
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, hsa_queue=q,
                      hsa_scheduler=sched, device="cpu")

    def broken_prefill(*a, **k):
        raise _Boom("prefill failed on the device")

    eng.model = type("Broken", (), {"prefill": staticmethod(broken_prefill),
                                    "device": model.device})()
    eng.submit([1, 2, 3], max_new_tokens=2)
    if threaded:
        sched.start()
    try:
        with pytest.raises(_Boom, match="prefill failed"):
            eng.step()
    finally:
        if threaded:
            sched.stop()
    assert sched.queue_report()["tf-serving"]["dispatched"] == 1
