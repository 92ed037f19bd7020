"""Tables I-V and the harness on the port against the JAX package's
``benchmarks/``, on the CPU.

- Tables IV and V: their costs are measured, so each package's rows are its
  own; given one fixed cost table (``FIXED``, handed to both), the port's
  schedules equal JAX's: the idle fractions, makespans, per-queue reports,
  exposed and hidden reconfiguration, prefetch counts, and every ledger
  category's record count (their virtual totals too; the host-timed
  categories aside).
- Table I's KV and overcommit rows, Table II's counts and hit rate, Table
  III's operation counts, against JAX's.
- ``paper_roles.calibrate_costs`` and ``hopper_footprints``.
- The harness: ``parse_row``, the trajectory guard's lists and ``check``
  against JAX's on synthetic payloads, the suites' order and caps, a run of
  three tables to JSON, and no module of ``repro_torch.bench`` importing
  ``jax``, ``repro`` or ``benchmarks``.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from benchmarks import run as jrun
from benchmarks import table1_utilization as jtable1
from benchmarks import table2_overhead as jtable2
from benchmarks import table3_efficiency as jtable3
from benchmarks import table4_multitenancy as jtable4
from benchmarks import table5_prefetch as jtable5
from benchmarks import trajectory as jtrajectory
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import dispatch as jdispatch
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro_torch import paper_roles
from repro_torch.bench import run, trajectory
from repro_torch.bench import table1_utilization as table1
from repro_torch.bench import table2_overhead as table2
from repro_torch.bench import table3_efficiency as table3
from repro_torch.bench import table4_multitenancy as table4
from repro_torch.bench import table5_prefetch as table5
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.core.ledger import OverheadLedger
from repro_torch.core.roles import RoleLibrary
from repro_torch.hw import H100_SXM
from repro_torch.kernels import conv2d as conv_k
from repro_torch.kernels import matmul as mm_k
from repro_torch.models import build_model, params_from_jax

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "src" / "repro_torch" / "bench"


class FixedCosts(dict):
    """A cost table whose ``get`` ignores the measured default: a packet it
    does not list (the engine's) costs 0.4 ms, so every schedule is a
    function of this table alone."""

    def get(self, key, default=None):
        return super().get(key, 4e-4)


FIXED = FixedCosts({
    ("reconfig", "role1_fc"): 3e-3, ("exec", "role1_fc"): 3e-4,
    ("reconfig", "role2_fc_barrier"): 3.5e-3, ("exec", "role2_fc_barrier"): 3e-4,
    ("reconfig", "role3_conv5x5"): 2e-3, ("exec", "role3_conv5x5"): 1e-4,
    ("reconfig", "role4_conv3x3"): 2.5e-3, ("exec", "role4_conv3x3"): 1.5e-4,
})

#: ledger categories whose totals are the virtual clock's (the others are
#: timed on the host)
VIRTUAL = ("wait", "reconfig_exposed")


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


def as_dict(rows: list[str]) -> dict[str, tuple[str, str]]:
    """JAX's CSV rows as the port's metric -> (value, derived)."""
    return {r.split(",", 3)[1]: tuple(r.split(",", 3)[2:]) for r in rows}


def ledger_cells(derived: str) -> dict[str, tuple[int, int]]:
    """A ``ledger_*`` row's ``cat=USus/nN`` cells: cat -> (µs, n)."""
    return {c: (int(us), int(n)) for c, us, n in re.findall(r"(\w+)=(\d+)us/n(\d+)", derived)}


# ---------------------------------------------------------------------------
# Tables IV and V on one fixed cost table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [16, 64])
def test_table4_schedule_equals_the_jax_benchmark(model, monkeypatch, n):
    """``table4.rows`` and JAX's ``run`` on ``FIXED``: the idle fractions,
    makespans and queue reports equal; the ledger rows' record counts equal,
    and their virtual totals."""
    m, p = model
    monkeypatch.setattr(jtable4, "calibrate_costs", lambda roles: FIXED)
    with jdispatch.use(prefer=("reference",)):
        want = as_dict(jtable4.run(n))
    with dispatch.use(prefer=("reference",)):
        got = table4.rows(n, model=m, params=p, costs=FIXED)
    assert set(got) == set(want)
    for metric in got:
        if metric.startswith("ledger_"):
            g, w = ledger_cells(got[metric][1]), ledger_cells(want[metric][1])
            assert {c: v[1] for c, v in g.items()} == {c: v[1] for c, v in w.items()}, metric
            assert {c: g[c][0] for c in VIRTUAL if c in g} == {
                c: w[c][0] for c in VIRTUAL if c in w}, metric
        else:
            assert got[metric] == want[metric], metric
    table4.check(got, complete=True)


@pytest.mark.parametrize("n", [24, 64])
def test_table5_schedule_equals_the_jax_benchmark(monkeypatch, n):
    """``table5.rows`` and JAX's ``run`` on ``FIXED``: every row equal (the
    sweep is role packets alone, all priced by the table)."""
    monkeypatch.setattr(jtable5, "calibrate_costs", lambda roles: FIXED)
    want = as_dict(jtable5.run(n))
    got = table5.rows(n, device="cpu", costs=FIXED)
    assert got == want
    assert got["prefetch_wins"][0] == "1"
    table5.check(got, complete=True)


def test_tables4_and_5_constants_equal_the_jax_benchmarks():
    assert table4.BG_ORDER == jtable4.BG_ORDER
    assert (table5.SWEEP, table5.BG_CYCLE, table5.NUM_REGIONS, table5.BURST) == (
        jtable5.SWEEP, jtable5.BG_CYCLE, jtable5.NUM_REGIONS, jtable5.BURST)


# ---------------------------------------------------------------------------
# Tables I-III
# ---------------------------------------------------------------------------


def test_table1_kv_and_overcommit_rows_equal_the_jax_benchmark():
    want = as_dict(jtable1.kv_utilization_rows())
    got = table1.kv_utilization_rows()
    assert got == want
    table1.check(got, complete=True)


def test_table1_role_rows_read_the_hopper_footprints():
    got = table1.rows(device="cpu")
    fps = paper_roles.hopper_footprints()
    for name, fp in fps.items():
        cells = dict(c.split("=") for c in got[name][1].split(";"))
        assert int(cells["smem_bytes"]) == fp.smem_bytes
        assert int(cells["threads"]) == fp.threads
        assert cells["smem_pct"] == f"{100 * fp.smem_bytes / H100_SXM.vmem_bytes:.2f}"
    assert got["shell"][1].startswith("state_bytes=")
    table1.check(got, complete=True)


def test_table2_counts_equal_the_jax_benchmark():
    """At n = 100: the reconfiguration count (a burst of four repeats a
    miss) and hit rate, and both dispatch counts, JAX's."""
    want = as_dict(jtable2.run(n=100))
    got = table2.rows(100, device="cpu")
    assert set(got) == set(want)
    for metric in ("reconfiguration", "dispatch_latency_hsa", "dispatch_latency_framework"):
        assert got[metric][1] == want[metric][1], metric
    table2.check(got, complete=True)
    with pytest.raises(AssertionError, match="reconfiguration"):
        table2.check(table2.rows(20, device="cpu"), complete=True)


def test_table3_operations_and_h100_target():
    """The operation counts and host clock are JAX's; ``h100_target_us`` is
    the larger of the bytes at 3.35 TB/s and the operations at the kernel's
    rate (3xTF32, int32)."""
    assert table3.HOST_HZ == jtable3.HOST_HZ
    names = ("role1_fc", "role2_fc_barrier", "role3_conv5x5", "role4_conv3x3")
    for name in names:
        assert table3.flops(name) == jtable3._flops(name)
    fc = max(3 * 2 * 256 ** 3 / 495e12, 4 * 3 * 256 ** 2 / 3.35e12) * 1e6
    assert table3.h100_target_us("role1_fc") == pytest.approx(fc, rel=1e-12)
    conv = max(2 * 60 * 60 * 25 / 33.5e12, (2 * (64 * 64 + 25) + 4 * 60 * 60) / 3.35e12) * 1e6
    assert table3.h100_target_us("role3_conv5x5") == pytest.approx(conv, rel=1e-12)
    got = table3.rows(2, device="cpu")
    assert list(got) == list(names)
    for name in names:
        assert [c.split("=")[0] for c in got[name][1].split(";")] == [
            "op_cycle_increase", "base_us", "opc_base", "opc_accel", "h100_target_us"]
    table3.check(got, complete=True)


# ---------------------------------------------------------------------------
# paper_roles' helpers
# ---------------------------------------------------------------------------


def test_calibrate_costs_measures_each_role_and_unloads_it():
    roles = paper_roles.make_paper_roles(RoleLibrary(ledger=OverheadLedger()), device="cpu")
    costs = paper_roles.calibrate_costs(roles, reps=3)
    assert set(costs) == {(kind, name) for name in roles for kind in ("reconfig", "exec")}
    assert all(v > 0 for v in costs.values())
    assert not any(role.resident for role, _ in roles.values())
    assert all(role.load_count == 1 for role, _ in roles.values())


def test_hopper_footprints_are_the_kernels_blocks():
    fps = paper_roles.hopper_footprints()
    assert sorted(fps) == sorted(("role1_fc", "role2_fc_barrier", "role3_conv5x5",
                                  "role4_conv3x3"))
    assert fps["role1_fc"] == fps["role2_fc_barrier"] == mm_k.footprint(f32=True)
    assert fps["role3_conv5x5"] == conv_k.footprint(1, 5, 5, 1, 2)
    assert fps["role4_conv3x3"] == conv_k.footprint(1, 3, 3, 2, 2)
    assert all(fp.smem_bytes <= H100_SXM.vmem_bytes for fp in fps.values())


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row", [
    "table7,paged_wins,1,ratio_x=2.45;page_size=16;pool=1024",
    "table4,ledger_serve,0,dispatch=1us/n1,with,commas",
    "table9,x,not-a-number,d", "table1,shell", "bare",
])
def test_parse_row_equals_the_jax_harness(row):
    assert run.parse_row(row) == jrun.parse_row(row)


def test_trajectory_lists_equal_the_jax_guard():
    assert trajectory.ASSERTED == jtrajectory.ASSERTED
    assert trajectory.TRACKED == jtrajectory.TRACKED
    assert trajectory.LOWER_IS_BETTER == jtrajectory.LOWER_IS_BETTER
    assert trajectory.TOLERANCE == jtrajectory.TOLERANCE


def _payload(values: dict) -> dict:
    return {"schema": 2, "rows": [{"table": t, "metric": m, "value": v, "derived": ""}
                                  for (t, m), v in values.items()]}


@pytest.mark.parametrize("case", ["holds", "asserted_zero", "asserted_missing", "tracked_drop",
                                  "lower_rise", "tracked_gone", "new_metric"])
def test_trajectory_check_equals_the_jax_guard(case):
    base = {**{k: 1.0 for k in jtrajectory.ASSERTED}, **{k: 10.0 for k in jtrajectory.TRACKED}}
    cur = dict(base)
    if case == "asserted_zero":
        cur[("table7", "paged_wins")] = 0.0
    elif case == "asserted_missing":
        del cur[("table13", "prefix_wins")]
    elif case == "tracked_drop":
        cur[("table7", "paged_trace_ps16_pool1024")] = 8.9
    elif case == "lower_rise":
        cur[("table9", "ttft_p99_us_bursty_chunked")] = 11.2
    elif case == "tracked_gone":
        del cur[("table1", "kv_cache_paged")]
    elif case == "new_metric":
        del base[("table13", "prefix_pages_saved_frac")]
    got = trajectory.check(_payload(base), _payload(cur))
    assert got == jtrajectory.check(_payload(base), _payload(cur))
    assert (got == []) == (case in ("holds", "new_metric"))


def test_suites_follow_the_jax_harness():
    """The tables in the JAX harness's order, each at its cap (read off
    ``benchmarks/run.py``)."""
    src = (ROOT / "benchmarks" / "run.py").read_text()
    suites = re.findall(r"\((table\d+)_(\w+)\.run, \{([^}]*)\}\)", src)
    for n in (100, 1000):
        want = []
        for table, name, kw in suites:
            m = re.search(r'"n": (.*)', kw)
            want.append((table, f"{table}_{name}", eval(m.group(1), {"n": n, "min": min})
                         if m else 0))
        assert run.suites(n) == want


def test_run_writes_schema_2_and_fails_on_a_parted_row(model, monkeypatch, tmp_path):
    """Three tables through ``run.main`` to JSON (schema 2, the rows in
    order); a row that parts from ``EXPECTED`` makes it exit 1."""
    m, p = model
    monkeypatch.setattr(run, "suites", lambda n: [("table1", "table1_utilization", 0),
                                                  ("table7", "table7_paged", 64),
                                                  ("table13", "table13_prefix", 64)])
    from repro_torch.bench import common

    monkeypatch.setattr(common, "serve_model", lambda device, seed=0: (m, p))
    out = tmp_path / "rows.json"
    with dispatch.use(prefer=("reference",)):
        assert run.main(["--fast", "--device", "cpu", "--json", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert payload["schema"] == run.JSON_SCHEMA == jrun.JSON_SCHEMA
    assert payload["fast"] is True
    assert [r["table"] for r in payload["rows"]] == ["table1"] * 8 + ["table7"] * 11 + [
        "table13"] * 6
    from repro_torch.bench import table7_paged

    monkeypatch.setitem(table7_paged.EXPECTED, "paged_wins", ("1", "ratio_x=9.99"))
    with dispatch.use(prefer=("reference",)):
        assert run.main(["--fast", "--device", "cpu"]) == 1


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.glob("*.py")) + [BENCH.parent / "paper_roles.py"],
                         ids=lambda p: p.name)
def test_bench_modules_import_no_jax(path):
    assert not _imports(path) & {"jax", "jaxlib", "repro", "benchmarks"}, path.name


def test_every_jax_table_has_a_port():
    jax_tables = {p.stem for p in (ROOT / "benchmarks").glob("table*.py")}
    assert jax_tables <= {p.stem for p in BENCH.glob("table*.py")}
    for name in ("run", "trajectory"):
        assert importlib.util.find_spec(f"repro_torch.bench.{name}") is not None
