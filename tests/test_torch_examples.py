"""The port's examples (``repro_torch.examples``) at their small size on the
CPU, where every kernel's wrapper runs its plain version: each runs to
its end through ``main`` and its own checks hold (policies agree with the
oracle, fused equals unfused, paged, overcommitted and tiered equal dense,
conv frames equal the plain conv2d, the LRU thrashes below the working
set).  Against the JAX package's own scripts: ``quickstart``'s MLP outputs
on the same draws, ``multi_tenant``'s virtual-clock schedule at full size,
``reconfig_demo``'s plans and residency counts.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro_torch.examples import multi_tenant, quickstart, reconfig_demo, serve_lm

ROOT = Path(__file__).resolve().parents[1]


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(rel.replace("/", "_")[:-3], ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mod", [quickstart, multi_tenant, reconfig_demo, serve_lm],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_example_main_runs_on_the_cpu(mod, capsys):
    assert mod.main(["--device", "cpu", "--small"]) == 0
    assert capsys.readouterr().out.strip()


def test_quickstart_policies_agree_and_equal_jax():
    import jax.numpy as jnp

    import repro.kernels  # noqa: F401
    from repro.core import dispatch as jdispatch

    got = quickstart.run("cpu", verbose=False)
    assert max(got["max_err"].values()) <= quickstart.TOL
    jq = _load("examples/quickstart.py")
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(64, 128)), jnp.float32)
    w1 = jnp.asarray(rng.normal(size=(128, 256)) * 0.05, jnp.float32)
    w2 = jnp.asarray(rng.normal(size=(256, 32)) * 0.05, jnp.float32)
    with jdispatch.use(prefer=jdispatch.policy_from_flag("reference")):
        want = np.asarray(jq.tiny_mlp(x, w1, w2))
    for policy, out in got["outs"].items():
        np.testing.assert_allclose(out, want, atol=1e-4, rtol=1e-4, err_msg=policy)
    assert got["residency"]["misses"] == 2 and got["residency"]["hits"] == 8


def test_multi_tenant_schedule_equals_jax():
    want = _load("examples/multi_tenant.py")._run(0)
    got = multi_tenant._run(0)
    assert [(e.t, e.kind, e.queue, e.what) for e in got.event_log()] == \
        [(e.t, e.kind, e.queue, e.what) for e in want.event_log()]
    assert got.timeline() == want.timeline()
    res = multi_tenant.run("cpu", small=True, verbose=False)
    assert res["lookahead_exposed_reconfig_s"] < res["exposed_reconfig_s"]
    assert res["prefetch_events"] > 0 and res["burst_packets"] == 4


def test_reconfig_demo_plans_and_residency():
    from repro.core import policy as jpolicy

    res = reconfig_demo.run("cpu", small=True, verbose=False)
    W = len(reconfig_demo.DIMS)
    sweep = res["sweep"]
    assert sweep[1]["misses"] == 3 * W and sweep[W]["misses"] == W
    assert all(sweep[b]["misses"] == W for b in range(W, W + 3))
    cost = jpolicy.CostModel(reconfig_s=3e-3, dispatch_s=50e-6, exec_generic_s={"fc": 300e-6},
                             exec_fixed_s={"fc": 200e-6})
    for n, got in res["plans"].items():
        plan = jpolicy.plan_roles([jpolicy.Invocation("fc", i) for i in range(n)], budget=4,
                                  cost=cost)
        assert got == {"assignment": plan.assignment["fc"],
                       "predicted_s": plan.predicted.total_s}


def test_serve_lm_checks_hold_under_every_policy():
    for policy in ("cuda-strict", "torch"):
        res = serve_lm.run("cpu", small=True, verbose=False, policy=policy)
        assert all(res["checks"].values()) and len(res["streams"]) == len(serve_lm.PROMPTS)
        assert res["preemptions"] > 0 and res["spills"] > 0
