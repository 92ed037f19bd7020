"""The port's engine clock, arrival times and ``ChunkPolicy`` against the
JAX package's, on the CPU.

``tests/test_traffic.py``'s virtual-clock cases replayed on both engines on
the same weights (``params_from_jax``, the reduced ``llama3.2-1b`` that file
builds): every request's ``arrival_t``, ``first_token_t`` and ``finish_t``
and the ledger's ``traffic_split()`` equal the JAX engine's exactly (float
``==``: each is a property of the schedule and the step time model), and so
do the mid-flight submit case, ``ChunkPolicy.choose_chunk`` over a grid,
and the streams and timestamps under a tapered ``ChunkPolicy`` (dense and
paged, greedy and T = 0.7); ``tests/test_torch_table9.py`` holds Table IX's
replays.
The wall-clock feeder case is the port's own: the feeder submits once the
engine has stepped, and the engine's next step waits for it, so no timing
window decides the test.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import dispatch as jdispatch
from repro.core.hsa.clock import VirtualClock as JVirtualClock
from repro.core.ledger import OverheadLedger as JOverheadLedger
from repro.core.policy import ChunkPolicy as JChunkPolicy
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.core.hsa.clock import VirtualClock
from repro_torch.core.ledger import OverheadLedger
from repro_torch.core.policy import ChunkPolicy
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve.engine import ServeEngine

PROMPTS = [list(range(3, 23)), [7, 8], [1, 2, 3, 4, 5, 6], [42]]

#: tests/test_traffic.py's trace: (arrival_s, prompt, max_new)
TRACE = [
    (0.000, list(range(3, 23)), 5),
    (0.001, [7, 8], 4),
    (0.004, [1, 2, 3, 4, 5, 6], 3),
    (0.030, [42], 6),
    (0.031, [9, 9, 9], 1),
    (0.090, [5, 4, 3, 2], 4),
]

#: prompts long enough that a tapered policy's chunk matters (buckets of 128
#: and 256 against chunks of 16 to 64), arriving while others decode
TAPER_TRACE = [
    (0.000, [(5 * i + 1) % 128 for i in range(100)], 6),
    (0.001, [7, 8, 9], 6),
    (0.002, [(3 * i + 2) % 128 for i in range(40)], 5),
    (0.003, [11, 12], 6),
    (0.010, [(7 * i + 5) % 128 for i in range(130)], 4),
    (0.011, [1, 2, 3, 4], 6),
    (0.030, [(11 * i + 3) % 128 for i in range(60)], 3),
]
TAPER = dict(max_chunk=64, min_chunk=16, decode_taper=2, fusion_taper=2)
#: the dispatch policy pairs of tests/test_torch_chunked.py: (JAX, port)
POLICIES = {
    "reference": (("reference",), ("reference",)),
    "default": (("xla", "reference"), ("torch", "reference")),
}


def _step_time(prefill_tokens: int, decode_tokens: int) -> float:
    return 1e-3 + 1e-4 * prefill_tokens + 5e-5 * decode_tokens


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


def _busy(eng) -> bool:
    return bool(eng._active or eng._prefilling or eng._queue or getattr(eng, "_parked", None))


def _replay(eng, clock, trace) -> list:
    """``tests/test_traffic.py``'s ``_replay`` on a built engine: arrivals
    submitted at the first step boundary at or after their time, backdated;
    the clock jumps to the next arrival when the engine is idle.  The
    completed requests, uid-sorted."""
    i, done = 0, []
    while True:
        while i < len(trace) and trace[i][0] <= clock.now():
            t_a, p, m = trace[i]
            eng.submit(p, max_new_tokens=m, arrival_t=t_a)
            i += 1
        if not _busy(eng):
            if i >= len(trace):
                break
            clock.advance_to(trace[i][0])
            continue
        done += eng.step()
    return sorted(done, key=lambda r: r.uid)


def _both(models, trace, *, chunk, jchunk=None, **kw):
    """The trace through the JAX engine and the port's, each on its own
    virtual clock and ledger: (requests, ledger) for each."""
    jmodel, jparams, model, params = models
    out = []
    for engine, m, p, clock, led, c, extra in (
            (JServeEngine, jmodel, jparams, JVirtualClock(), JOverheadLedger(),
             chunk if jchunk is None else jchunk, {}),
            (ServeEngine, model, params, VirtualClock(), OverheadLedger(), chunk,
             {"device": "cpu"})):
        eng = engine(m, p, prefill_chunk=c, clock=clock, step_time_model=_step_time,
                     ledger=led, **kw, **extra)
        out.append((_replay(eng, clock, trace), led))
    return out


def _times(done) -> list[tuple]:
    return [(r.uid, r.arrival_t, r.first_token_t, r.finish_t) for r in done]


@pytest.mark.parametrize("chunk", [None, 4, 16], ids=["whole", "chunk4", "chunk16"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_replay_timestamps_and_traffic_split_equal_jax(models, chunk, paged):
    (jdone, jled), (done, led) = _both(models, TRACE, chunk=chunk, batch_slots=2, max_len=64,
                                       decode_fusion=2, paged=paged, page_size=16)
    assert len(done) == len(TRACE)
    assert _times(done) == _times(jdone)
    assert [r.generated for r in done] == [r.generated for r in jdone]
    assert led.traffic_split() == jled.traffic_split()
    assert led.traffic_split()["ttft_n"] == float(len(TRACE))


def test_midflight_submit_virtualclock_equals_jax(models):
    """``test_midflight_submit_virtualclock_deterministic`` on both engines:
    the late request is queued, admitted at the next step boundary, stamps
    its backdated arrival, and every timestamp equals the JAX engine's."""
    jmodel, jparams, model, params = models
    runs = []
    for engine, m, p, clock, extra in ((JServeEngine, jmodel, jparams, JVirtualClock(), {}),
                                       (ServeEngine, model, params, VirtualClock(),
                                        {"device": "cpu"})):
        eng = engine(m, p, batch_slots=2, max_len=64, decode_fusion=2, paged=True, page_size=16,
                     prefill_chunk=4, clock=clock, step_time_model=_step_time, **extra)
        first = [eng.submit(PROMPTS[0], max_new_tokens=8),
                 eng.submit(PROMPTS[1], max_new_tokens=8)]
        done = eng.step()
        t_mid = eng.clock.now()
        late = eng.submit(PROMPTS[2], max_new_tokens=3, arrival_t=t_mid)
        assert any(r.uid == late for r in eng._queue), "late submit not queued"
        for _ in range(200):
            done += eng.step()
            if {r.uid for r in done} == set(first) | {late}:
                break
        else:
            pytest.fail(f"late request never completed: {[r.uid for r in done]}")
        req = next(r for r in done if r.uid == late)
        assert req.arrival_t == t_mid and t_mid <= req.first_token_t <= req.finish_t
        assert len(req.generated) == 3
        runs.append(_times(sorted(done, key=lambda r: r.uid)))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("max_chunk,min_chunk", [(16, 16), (64, 16), (64, 1), (128, 4),
                                                 (256, 32)])
def test_choose_chunk_equals_jax_over_a_grid(max_chunk, min_chunk):
    for dt, ft in itertools.product((0, 1, 2, 3), (0, 1, 2)):
        pol = ChunkPolicy(max_chunk, min_chunk, dt, ft)
        jpol = JChunkPolicy(max_chunk, min_chunk, dt, ft)
        for live, k in itertools.product(range(9), range(1, 9)):
            got = pol.choose_chunk(live_decode=live, fusion_k=k)
            assert got == jpol.choose_chunk(live_decode=live, fusion_k=k), (dt, ft, live, k)
            assert min_chunk <= got <= max_chunk and got & (got - 1) == 0


def test_chunk_policy_validation_and_of_equal_jax():
    for bad in (dict(max_chunk=12), dict(min_chunk=0), dict(max_chunk=8, min_chunk=16),
                dict(decode_taper=-1), dict(fusion_taper=-2)):
        with pytest.raises(ValueError) as want:
            JChunkPolicy(**bad)
        with pytest.raises(ValueError) as got:
            ChunkPolicy(**bad)
        assert str(got.value) == str(want.value)
    assert ChunkPolicy.of(None) is None and ChunkPolicy.of(32) == ChunkPolicy(32, 32)
    pol = ChunkPolicy(**TAPER)
    assert ChunkPolicy.of(pol) is pol
    assert dataclasses.asdict(pol) == dataclasses.asdict(JChunkPolicy(**TAPER))


@pytest.mark.parametrize("paged,temperature,seed,policy", [
    (False, 0.0, 0, "reference"), (True, 0.0, 0, "reference"),
    (False, 0.7, 3, "reference"), (True, 0.7, 3, "reference"),
    (False, 0.0, 0, "default"),
], ids=["dense-greedy", "paged-greedy", "dense-t0.7", "paged-t0.7", "dense-greedy-default"])
def test_tapered_policy_streams_and_timestamps_equal_jax(models, paged, temperature, seed,
                                                         policy):
    """A tapered ``ChunkPolicy`` (64-row chunks, halved for every two live
    slots and every two fused steps, at least 16) on both engines: the
    timestamps and ``traffic_split()`` equal the JAX engine's, and the
    port's chunked streams equal its own whole-prompt streams.  Under the
    ``reference`` pair (f32 products) the streams equal the JAX engine's
    too; under the default pair the two packages round bf16 at other places
    (ROADMAP §3, known differences), and on this trace one greedy stream
    parts from JAX's at a near-tie, chunked and whole alike."""
    jprefer, tprefer = POLICIES[policy]
    kw = dict(batch_slots=4, max_len=256, decode_fusion=4, paged=paged, page_size=16,
              temperature=temperature, seed=seed)
    _, _, model, params = models
    with jdispatch.use(prefer=jprefer), dispatch.use(prefer=tprefer):
        (jdone, jled), (done, led) = _both(models, TAPER_TRACE, chunk=ChunkPolicy(**TAPER),
                                           jchunk=JChunkPolicy(**TAPER), **kw)
        clock = VirtualClock()
        whole = _replay(ServeEngine(model, params, clock=clock, step_time_model=_step_time,
                                    device="cpu", **kw), clock, TAPER_TRACE)
    assert len(done) == len(TAPER_TRACE)
    assert _times(done) == _times(jdone)
    assert led.traffic_split() == jled.traffic_split()
    assert [r.generated for r in whole] == [r.generated for r in done]
    if policy == "reference":
        assert [r.generated for r in done] == [r.generated for r in jdone]


def test_tapered_policy_picks_chunks_from_live_traffic(models):
    """The policy's chunk is fixed at each prefill's start: a prompt admitted
    into an idle engine takes 64 rows; one admitted beside three live slots
    after a launch of depth 4 takes 64 / 2 / 4, held at the 16-row floor,
    for its whole prefill."""
    _, _, model, params = models
    picked = []

    class Engine(ServeEngine):
        def _start_chunked(self, slot, req):
            super()._start_chunked(slot, req)
            picked.append((len(req.prompt), self._prefilling[slot].chunk))

    eng = Engine(model, params, batch_slots=4, max_len=256, decode_fusion=4,
                 prefill_chunk=ChunkPolicy(**TAPER), clock=VirtualClock(),
                 step_time_model=_step_time, device="cpu")
    eng.submit(TAPER_TRACE[0][1], max_new_tokens=2)
    eng.run_to_completion()
    for p in ([7, 8, 9], [11, 12], [1, 2, 3, 4]):
        eng.submit(p, max_new_tokens=12)
    while len(eng._active) < 3 or eng._last_fusion_k != 4:
        eng.step()
    eng.submit(TAPER_TRACE[4][1], max_new_tokens=4)
    calls = eng.chunk_calls
    eng.run_to_completion()
    assert picked == [(100, 64), (3, 64), (2, 64), (4, 64), (130, 16)]
    assert eng.chunk_calls - calls == 256 // 16          # the 256-row bucket in 16-row chunks


def test_midflight_submit_wallclock_feeder_thread_waits_on_engine_state(models):
    """submit() from a feeder thread while run_to_completion is mid-flight on
    the wall clock: the feeder submits once the engine has taken its first
    step, and the engine's next step waits until it has, so the late
    requests always arrive mid-flight; they are admitted at a step boundary
    and finish, never lost or misclassified as rejected."""
    _, _, model, params = models
    stepped, submitted = threading.Event(), threading.Event()

    class Engine(ServeEngine):
        def step(self):
            if stepped.is_set():
                assert submitted.wait(timeout=60), "the feeder never submitted"
            out = super().step()
            stepped.set()
            return out

    eng = Engine(model, params, batch_slots=2, max_len=64, decode_fusion=2, prefill_chunk=4,
                 device="cpu")
    first = [eng.submit(p, max_new_tokens=12) for p in PROMPTS[:2]]
    late: list[int] = []

    def feeder():
        stepped.wait(timeout=60)
        late.extend(eng.submit(p, max_new_tokens=4) for p in PROMPTS[2:])
        submitted.set()

    th = threading.Thread(target=feeder)
    th.start()
    done = eng.run_to_completion()
    th.join()
    assert sorted(r.uid for r in done) == sorted(first + late) and len(late) == 2
    by_uid = {r.uid: r for r in done}
    assert all(len(by_uid[u].generated) == 12 for u in first)
    assert all(len(by_uid[u].generated) == 4 for u in late)
    assert all(by_uid[u].arrival_t <= by_uid[u].first_token_t <= by_uid[u].finish_t
               for u in first + late)
