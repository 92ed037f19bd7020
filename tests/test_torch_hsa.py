"""The port's HSA control plane against the JAX package's, on the CPU.

The same scenario — roles, two tenants' queues, burst and barrier-AND
packets, a ``VirtualClock`` and a fixed cost model — runs through both
packages' ``RoleLibrary``, ``RegionManager`` and async ``Scheduler``.
Everything on virtual time must be *exactly* equal: the event log, the
timeline, per-queue stats, the ledger's category counts and virtual-time
totals, ``reconfig_split()``, residency and prefetch stats and the fault
trace; packet outputs agree within f32 rounding.  The sweep covers region
budgets 1-4, lookahead 0-2, burst grants on/off and a seeded fault plan
on/off.  ``examples/multi_tenant.py``'s ``_run`` scenario, the region-budget
sweep of ``examples/reconfig_demo.py`` and ``plan_roles`` on that script's
cost model are replayed too, and the paper's four roles get equal keys,
names and region-image digests.
"""

from __future__ import annotations

import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401  (registers the JAX kernels)
from repro.core import hsa as jhsa
from repro.core import ledger as jledger
from repro.core import policy as jpolicy
from repro.core import reconfig as jreconfig
from repro.core import registry as jregistry
from repro.core import roles as jroles
from repro_torch import paper_roles
from repro_torch.core import hsa as thsa
from repro_torch.core import ledger as tledger
from repro_torch.core import policy as tpolicy
from repro_torch.core import reconfig as treconfig
from repro_torch.core import registry as tregistry
from repro_torch.core import roles as troles

ROOT = Path(__file__).resolve().parents[1]

# categories recorded on the scheduler's (virtual) clock: their totals must
# match exactly; the rest (DISPATCH, EXEC, RECONFIG, SETUP, submit, grant)
# are measured host times, compared by count
VIRTUAL = ("wait", "reconfig_exposed", "reconfig_hidden", "fault", "retry")


def _load(rel: str) -> types.ModuleType:
    """A fresh copy of a repo script (its module-level RNG restarts)."""
    spec = importlib.util.spec_from_file_location(f"_script_{Path(rel).stem}", ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# one scenario, written once, run through either package
# ---------------------------------------------------------------------------

JAX = types.SimpleNamespace(
    hsa=jhsa, ledger=jledger, reconfig=jreconfig, registry=jregistry, roles=jroles,
    policy=jpolicy, source="xla",
    spec=lambda shape, dt: jax.ShapeDtypeStruct(shape, {"f32": jnp.float32, "i16": jnp.int16}[dt]),
    array=lambda a: jnp.asarray(a),
    role_kw={},
    fc=lambda x, w: jnp.dot(x, w, preferred_element_type=jnp.float32),
    conv=lambda x, w: jax.lax.conv_general_dilated(
        x.astype(jnp.int32), w.astype(jnp.int32), (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC")),
)
TORCH = types.SimpleNamespace(
    hsa=thsa, ledger=tledger, reconfig=treconfig, registry=tregistry, roles=troles,
    policy=tpolicy, source="torch",
    spec=lambda shape, dt: troles.ArgSpec(shape, {"f32": torch.float32, "i16": torch.int16}[dt]),
    array=lambda a: torch.from_numpy(np.ascontiguousarray(a)),
    role_kw={"device": "cpu"},
    fc=lambda x, w: torch.matmul(x, w),
    conv=lambda x, w: paper_roles.conv2d_k.plain_conv2d(x, w),
)

N_FC, IMG = 16, 12
MAX_STEPS = 3000


def _inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(N_FC, N_FC)).astype(np.float32),
        "w": rng.normal(size=(N_FC, N_FC)).astype(np.float32),
        "w2": rng.normal(size=(N_FC, N_FC)).astype(np.float32),
        "img": rng.integers(-100, 100, size=(1, IMG, IMG, 1)).astype(np.int16),
        "k5": rng.integers(-8, 8, size=(5, 5, 1, 1)).astype(np.int16),
        "k3": rng.integers(-8, 8, size=(3, 3, 1, 2)).astype(np.int16),
    }


def _scenario(pkg, *, budget: int, lookahead: int, burst_grants: bool, faulty: bool,
              steps: int = 6) -> dict:
    """Two tenants on one agent: "tf" submits bursts of FC packets and, every
    other step, a barrier-AND on the opencl tenant's latest conv then the
    barrier FC role; "opencl" cycles three conv roles through ``budget``
    regions.  Fixed costs per role; optionally a seeded fault plan with
    retries."""
    data = {k: pkg.array(v) for k, v in _inputs().items()}
    ledger = pkg.ledger.OverheadLedger()
    lib = pkg.roles.RoleLibrary(ledger=ledger)
    KernelImpl = pkg.registry.KernelImpl

    def role(op, fn, specs, name, spec=pkg.registry.GENERIC):
        impl = KernelImpl(op=op, device_kind="any", source=pkg.source, fn=fn,
                          specialization=spec)
        return lib.add(pkg.roles.Role(impl, specs, name=name, **pkg.role_kw))

    fspec = pkg.spec((N_FC, N_FC), "f32")
    ispec = pkg.spec((1, IMG, IMG, 1), "i16")
    fc = role("matmul", pkg.fc, (fspec, fspec), "role1_fc")
    fcb = role("fc_barrier", pkg.fc, (fspec, fspec), "role2_fc_barrier")
    fixed = pkg.registry.FIXED_WEIGHT
    convs = [
        role("role3_conv5x5", lambda x, k=data["k5"]: pkg.conv(x, k), (ispec,), "role3_conv5x5",
             fixed),
        role("role4_conv3x3", lambda x, k=data["k3"]: pkg.conv(x, k), (ispec,), "role4_conv3x3",
             fixed),
        role("conv5_generic", pkg.conv, (ispec, pkg.spec((5, 5, 1, 1), "i16")), "conv5_generic"),
    ]
    conv_args = [(data["img"],), (data["img"],), (data["img"], data["k5"])]
    lib.synthesize_all()

    plan = pkg.hsa.FaultPlan(seed=7, exec_rate=0.15, load_rate=0.1) if faulty else None
    cost = {"role1_fc": 1e-3, "role2_fc_barrier": 1.5e-3, "role3_conv5x5": 2e-3,
            "role4_conv3x3": 2.5e-3, "conv5_generic": 3e-3}

    def cost_model(kind, what, measured):
        return 4e-3 if kind == "reconfig" else cost.get(what, 0.5e-3)

    regions = pkg.reconfig.RegionManager(budget, ledger=ledger)
    sched = pkg.hsa.Scheduler(
        regions, lib, ledger=ledger, clock=pkg.hsa.VirtualClock(), cost_model=cost_model,
        lookahead=lookahead, burst_grants=burst_grants, faults=plan,
        retry=3 if faulty else None,
    )
    q_tf = sched.add_queue(pkg.hsa.Queue(None, 256, name="tf-serving"))
    q_cl = sched.add_queue(pkg.hsa.Queue(None, 256, name="opencl"))
    packets = []
    for step in range(steps):
        burst = [pkg.hsa.dispatch_packet(fc.key, data["x"], data["w"] if i % 2 else data["w2"],
                                         producer="tf") for i in range(3)]
        q_tf.submit_burst(burst)
        packets += burst
        c = step % len(convs)
        conv_pkt = q_cl.dispatch(convs[c].key, *conv_args[c], producer="opencl")
        packets.append(conv_pkt)
        if step % 2:
            q_tf.barrier([conv_pkt.completion])
            packets.append(q_tf.dispatch(fcb.key, data["x"], data["w"], producer="tf"))
    try:
        sched.run_until_idle(max_steps=MAX_STEPS)
        idle = True
    except RuntimeError:      # the livelock of one region between two tenants (see below)
        idle = False

    summary = ledger.summary()
    split = ledger.reconfig_split()
    return {
        "idle": idle,
        "events": [(e.t, e.kind, e.queue, e.what) for e in sched.event_log()],
        "timeline": sched.timeline(),
        "queues": sched.queue_report(),
        "counts": {c: v["count"] for c, v in summary.items()},
        "virtual_totals": {c: v["total_us"] for c, v in summary.items() if c in VIRTUAL},
        "reconfig_split": {k: v for k, v in split.items() if k != "measured_s"},
        "residency": vars(regions.stats).copy(),
        "faults": [(f.t, f.kind, f.what, f.queue, f.permanent) for f in plan.trace] if plan else [],
        "outputs": [None if p.out.value is None else np.asarray(p.out.value) for p in packets],
        "errors": [type(p.out.error).__name__ if p.out.error is not None else None
                   for p in packets],
    }


def _assert_same(got: dict, want: dict) -> None:
    for key in ("idle", "events", "timeline", "queues", "counts", "virtual_totals", "reconfig_split",
                "residency", "faults", "errors"):
        assert got[key] == want[key], key
    for g, w in zip(got["outputs"], want["outputs"], strict=True):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("faulty", [False, True], ids=["clean", "faults"])
@pytest.mark.parametrize("burst_grants", [True, False], ids=["burst", "noburst"])
@pytest.mark.parametrize("lookahead", [0, 1, 2])
@pytest.mark.parametrize("budget", [1, 2, 3, 4])
def test_control_plane_matches_jax(budget, lookahead, burst_grants, faulty):
    kw = dict(budget=budget, lookahead=lookahead, burst_grants=burst_grants, faulty=faulty)
    want = _scenario(JAX, **kw)
    got = _scenario(TORCH, **kw)
    _assert_same(got, want)
    assert got["events"], "the scenario ran nothing"
    if faulty:
        assert got["faults"], "the seeded fault plan injected nothing"


# ---------------------------------------------------------------------------
# examples/multi_tenant.py
# ---------------------------------------------------------------------------


def _torch_multi_tenant(lookahead: int, burst: bool):
    """``examples/multi_tenant.py``'s ``_run`` on the port: one FC role and
    two conv roles, two queues, 2 regions, the example's fixed costs."""
    rng = np.random.default_rng(0)
    ledger = tledger.OverheadLedger()
    lib = troles.RoleLibrary(ledger=ledger)
    import repro_torch.kernels.ops  # noqa: F401

    mm = tregistry.GLOBAL_REGISTRY.resolve("matmul", "any", ("torch",))
    conv = tregistry.GLOBAL_REGISTRY.resolve("conv2d", "any", ("torch", "reference"))
    a = troles.ArgSpec((128, 128), torch.float32)
    x = torch.tensor(rng.normal(size=(128, 128)), dtype=torch.float32)
    fc = lib.make_role(mm, (a, a), name="role1_fc", device="cpu")
    xi = torch.tensor(rng.normal(size=(1, 32, 32, 1)), dtype=torch.float32)
    xa = troles.ArgSpec((1, 32, 32, 1), torch.float32)
    convs = {}
    for name, k in (("role3_conv5x5", 5), ("role4_conv3x3", 3)):
        w = torch.tensor(rng.normal(size=(k, k, 1, 1)), dtype=torch.float32)
        convs[name] = (lib.make_role(conv, (xa, troles.ArgSpec((k, k, 1, 1), torch.float32)),
                                     name=name, device="cpu"), (xi, w))
    regions = treconfig.RegionManager(2, ledger=ledger)
    cost = {"reconfig": 5e-3, "exec": 1e-3}
    sched = thsa.Scheduler(regions, lib, ledger=ledger, clock=thsa.VirtualClock(),
                           cost_model=lambda kind, what, measured: cost[kind],
                           lookahead=lookahead)
    q_tf = sched.add_queue(thsa.Queue(None, 256, name="tf-serving"))
    q_cl = sched.add_queue(thsa.Queue(None, 256, name="opencl"))
    c5, c5_args = convs["role3_conv5x5"]
    c3, c3_args = convs["role4_conv3x3"]
    if burst:
        q_tf.submit_burst([thsa.dispatch_packet(fc.key, x, x, producer="tf") for _ in range(4)])
        for step in range(4):
            q_cl.dispatch((c5 if step % 2 == 0 else c3).key,
                          *(c5_args if step % 2 == 0 else c3_args), producer="opencl")
    else:
        for step in range(4):
            q_tf.dispatch(fc.key, x, x, producer="tf")
            q_cl.dispatch((c5 if step % 2 == 0 else c3).key,
                          *(c5_args if step % 2 == 0 else c3_args), producer="opencl")
    sched.run_until_idle()
    return sched


@pytest.mark.parametrize("lookahead,burst", [(0, False), (4, False), (0, True), (2, True)])
def test_multi_tenant_example_matches_jax(lookahead, burst):
    want = _load("examples/multi_tenant.py")._run(lookahead, burst)
    got = _torch_multi_tenant(lookahead, burst)
    assert [(e.t, e.kind, e.queue, e.what) for e in got.event_log()] == \
        [(e.t, e.kind, e.queue, e.what) for e in want.event_log()]
    assert got.timeline() == want.timeline()
    assert got.queue_report() == want.queue_report()
    assert got.exposed_reconfig_s() == want.exposed_reconfig_s()
    assert vars(got.regions.stats) == vars(want.regions.stats)
    # the device was shared: conv reconfigurations overlap FC execution
    kinds = {(e.kind, e.queue) for e in got.event_log()}
    assert ("exec_end", "tf-serving") in kinds and ("exec_end", "opencl") in kinds


# ---------------------------------------------------------------------------
# examples/reconfig_demo.py: the region-budget sweep and the role planner
# ---------------------------------------------------------------------------

DEMO_DIMS = [64, 96, 128, 160, 192, 224]


def _budget_sweep(pkg, roles, steps: int = 3) -> dict[int, tuple[float, int, int]]:
    out = {}
    for budget in range(1, len(roles) + 3):
        rm = pkg.reconfig.RegionManager(budget, ledger=pkg.ledger.OverheadLedger())
        for _ in range(steps):
            for role in roles:
                rm.ensure_resident(role)
        s = rm.stats
        out[budget] = (s.hit_rate, s.misses, s.evictions)
        rm.flush()
    return out


def test_reconfig_demo_budget_sweep_matches_jax():
    jimpl = jregistry.GLOBAL_REGISTRY.resolve("matmul", "any", ("xla",))
    jlib = jroles.RoleLibrary(ledger=jledger.OverheadLedger())
    jr = [jlib.add(jroles.Role(jimpl, (jax.ShapeDtypeStruct((d, d), jnp.float32),) * 2,
                               name=f"fc{d}")) for d in DEMO_DIMS]
    import repro_torch.kernels.ops  # noqa: F401

    timpl = tregistry.GLOBAL_REGISTRY.resolve("matmul", "any", ("torch",))
    tlib = troles.RoleLibrary(ledger=tledger.OverheadLedger())
    tr = [tlib.add(troles.Role(timpl, (troles.ArgSpec((d, d), torch.float32),) * 2,
                               name=f"fc{d}", device="cpu")) for d in DEMO_DIMS]
    want, got = _budget_sweep(JAX, jr), _budget_sweep(TORCH, tr)
    assert got == want
    # below the working set every access misses; at it, only compulsory misses
    assert got[1][0] == 0.0 and got[len(DEMO_DIMS)][1] == len(DEMO_DIMS)


@pytest.mark.parametrize("lookahead", [0, 2])
def test_plan_roles_matches_jax(lookahead):
    """``plan_roles`` for 3, 8 and 16 FC layers under a budget of 4 with the
    demo's cost model: the same assignment, predicted totals and
    alternatives."""
    def plan(pol, n):
        cost = pol.CostModel(reconfig_s=3e-3, dispatch_s=50e-6,
                             exec_generic_s={"fc": 300e-6}, exec_fixed_s={"fc": 200e-6})
        trace = [pol.Invocation("fc", i) for i in range(n)]
        p = pol.plan_roles(trace, budget=4, cost=cost, lookahead=lookahead)
        return p.assignment, vars(p.predicted), p.alternatives

    for n in (3, 8, 16):
        assert plan(tpolicy, n) == plan(jpolicy, n)
    assert plan(tpolicy, 3)[0] == {"fc": "fixed_weight"}
    assert plan(tpolicy, 16)[0] == {"fc": "generic"}


# ---------------------------------------------------------------------------
# the paper's four roles: keys, names, region-image digests
# ---------------------------------------------------------------------------


def test_paper_roles_keys_names_digests_match_jax():
    common = _load("benchmarks/common.py")
    want = common.make_paper_roles(jroles.RoleLibrary(ledger=jledger.OverheadLedger()))
    got = paper_roles.make_paper_roles(troles.RoleLibrary(ledger=tledger.OverheadLedger()),
                                       seed=0, device="cpu")
    assert sorted(got) == sorted(want)
    for name, (role, args) in got.items():
        jrole, jargs = want[name]
        assert repr(role.key) == repr(jrole.key) and str(role.key) == str(jrole.key)
        assert role.name == jrole.name and role.source == jrole.source
        assert treconfig.region_image_digest(role) == jreconfig.region_image_digest(jrole)
        for a, ja in zip(args, jargs, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(ja))


# ---------------------------------------------------------------------------
# the transfer engine and a stale region image, under a seeded fault plan
# ---------------------------------------------------------------------------

JAX.paged = importlib.import_module("repro.serve.paged")
JAX.bf16 = lambda a: jnp.asarray(a, dtype=jnp.bfloat16)
TORCH.paged = importlib.import_module("repro_torch.serve.paged")
TORCH.bf16 = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _err(e: Exception | None) -> str | None:
    return None if e is None else type(e).__name__


def _transfers(pkg, *, verify: bool) -> dict:
    """Spills (d2h) and refills (h2d) of small KV payloads on one engine
    timeline (virtual clock): refills waited a step later, some cancelled,
    one waited twice; a forced h2d fault, a forced corrupt transfer and
    seeded transfer faults and corruptions, with digest checks on or off."""
    rng = np.random.default_rng(3)
    clock = pkg.hsa.VirtualClock()
    ledger = pkg.ledger.OverheadLedger()
    plan = pkg.hsa.FaultPlan(seed=11, transfer_rate=0.2, corrupt_rate=0.3)
    plan.force("h2d", "uid=2")
    plan.force("corrupt_transfer", "uid=4")
    engine = pkg.reconfig.TransferEngine(
        bandwidth_bytes_s=1000.0, clock=clock, ledger=ledger, faults=plan, fault_backoff_s=0.25,
        integrity=types.SimpleNamespace(verify_transfers=verify))
    xfers, results, pending = [], [], []

    def wait(t):
        try:
            results.append((t.what, engine.wait(t), None))
        except Exception as e:  # noqa: BLE001  (the error's type is compared)
            results.append((t.what, None, _err(e)))

    for i in range(14):
        payload = {"k": pkg.array(rng.normal(size=(2, 4)).astype(np.float32)),
                   "v": pkg.bf16(rng.normal(size=(2, 4)))}
        kind = "d2h" if i % 3 == 0 else "h2d"
        t = engine.issue(kind, f"kv[uid={i}]", int(rng.integers(100, 900)), payload=payload,
                         digest=pkg.paged.tree_digest(payload))
        xfers.append(t)
        for p in pending:
            wait(p)
        pending.clear()
        if kind == "h2d":
            if i % 4 == 1:
                engine.cancel(t)
            else:
                pending.append(t)
        clock.advance(float(rng.choice([0.0, 0.2, 0.7])))
    for p in pending:
        wait(p)
    wait(next(t for t in xfers if t.waited and t.error is None))      # a second wait
    return {
        "transfers": [(t.kind, t.what, t.nbytes, t.start_t, t.ready_t, t.duration_s,
                       t.corrupted, t.waited, _err(t.error),
                       None if t.payload is None else pkg.paged.tree_digest(t.payload))
                      for t in xfers],
        "results": results,
        "stats": (engine.issued, engine.completed, engine.faulted, engine.cancelled,
                  engine.bytes_moved),
        "spill_split": ledger.spill_split(),
        "integrity_split": ledger.integrity_split(),
        "summary": ledger.summary(),
        "faults": [(f.t, f.kind, f.what, f.queue, f.permanent) for f in plan.trace],
    }


@pytest.mark.parametrize("verify", [True, False], ids=["verify", "noverify"])
def test_transfer_engine_matches_jax(verify):
    """The port's ``TransferEngine`` against JAX's on one script: every
    transfer's timeline, corruption and error, the payload digests (a
    corrupted payload's included), exposed waits, engine stats, the ledger's
    spill and integrity splits and totals, and the fault trace, exactly."""
    want, got = _transfers(JAX, verify=verify), _transfers(TORCH, verify=verify)
    for key in want:
        assert got[key] == want[key], key
    corrupted = [t for t in got["transfers"] if t[6]]
    assert corrupted and got["stats"][2] > 0           # the plan did fault and corrupt
    assert any(t[8] == "CorruptPayload" for t in corrupted) == verify


def _stale_regions(pkg, roles, *, verify: bool) -> dict:
    """Demand loads of ``roles`` through two regions with a seeded plan that
    hands some loads a stale image: caught at the load (verification on) or
    escaping at the first use (off)."""
    ledger = pkg.ledger.OverheadLedger()
    plan = pkg.hsa.FaultPlan(seed=5, corrupt_rate=0.35)
    plan.force("stale_region", roles[1].name)
    rm = pkg.reconfig.RegionManager(2, ledger=ledger, corrupt_hook=plan.stale_region_hook,
                                    verify_images=verify)
    seen = []
    for i in (0, 1, 2, 0, 1, 1, 0, 2, 2, 1, 0, 2, 1, 0, 0, 2):
        try:
            r = rm.ensure_resident(roles[i])
            seen.append((r.hit, None if r.evicted is None else str(r.evicted)))
        except Exception as e:  # noqa: BLE001  (the error's type is compared)
            seen.append(_err(e))
    return {"seen": seen, "residency": vars(rm.stats).copy(),
            "integrity_split": ledger.integrity_split(),
            "faults": [(f.kind, f.what, f.permanent) for f in plan.trace],
            "resident": sorted(str(k) for k in rm.resident_keys())}


@pytest.mark.parametrize("verify", [True, False], ids=["verify", "noverify"])
def test_stale_region_image_matches_jax(verify):
    jimpl = jregistry.GLOBAL_REGISTRY.resolve("matmul", "any", ("xla",))
    jlib = jroles.RoleLibrary(ledger=jledger.OverheadLedger())
    jr = [jlib.add(jroles.Role(jimpl, (jax.ShapeDtypeStruct((d, d), jnp.float32),) * 2,
                               name=f"fc{d}")) for d in DEMO_DIMS[:3]]
    import repro_torch.kernels.ops  # noqa: F401

    timpl = tregistry.GLOBAL_REGISTRY.resolve("matmul", "any", ("torch",))
    tlib = troles.RoleLibrary(ledger=tledger.OverheadLedger())
    tr = [tlib.add(troles.Role(timpl, (troles.ArgSpec((d, d), torch.float32),) * 2,
                               name=f"fc{d}", device="cpu")) for d in DEMO_DIMS[:3]]
    want, got = _stale_regions(JAX, jr, verify=verify), _stale_regions(TORCH, tr, verify=verify)
    assert got == want
    split = got["integrity_split"]
    assert ("StaleRegionImage" in got["seen"]) == verify
    assert (split["escaped"] > 0) == (not verify)
