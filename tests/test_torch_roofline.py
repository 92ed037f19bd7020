"""The port's card constants, specs and roofline against the JAX package's,
on the CPU, with no card.

Equal: ``hw.ChipSpec``'s fields by name (those the card has), ``get_shape``,
``cell_supported``, ``count_params`` / ``bytes_params``, ``abstract_params``
leaf by leaf, ``batch_specs``, ``decode_specs`` and ``abstract_opt_state``
for every configuration and shape at full size (specs only), JAX's stacked
leaf compared without its first entry against each per-layer leaf;
``collective_bytes`` against ``collective_bytes_from_hlo`` on HLO lines of
every kind at group sizes 2, 4 and 16 in iota and list form, with
``-start``/``-done`` pairs; ``model_flops`` exactly and ``roofline_terms``
up to the constants; ``report.py``'s tables on the same records.

Counted: the counter's FLOPs against XLA's ``cost_analysis`` of JAX's
unrolled model (the lowered module, before the CPU backend's rewrites) at
prefill and decode of reduced dense, vlm, MoE, MLA, SSM, hybrid and
encoder-decoder configurations, within ``XLA_FLOPS_REL_TOL``; each
dispatched op's cost against a sum worked out by hand, which is the
formula of that kernel's bound in ``chip_smoke.py``; views, gathers,
indexed writes and the peak of live bytes; and the affine fit over depth
equal to the direct count.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import hw as jhw
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_supported as jcell_supported
from repro.configs import get_shape as jget_shape
from repro.configs import reduced as jreduced
from repro.launch import specs as jspecs
from repro.models import build_model as jbuild
from repro.models import params as jparams
from repro.models.model import plan_segments as jplan_segments
from repro.roofline import analysis as janalysis
from repro.roofline import report as jreport
from repro.roofline.unrolling import unroll_inner_loops
from repro_torch import hw
from repro_torch.configs import ARCHS, SHAPES, cell_supported, get_shape, reduced
from repro_torch.core import dispatch
from repro_torch.kernels import ops  # noqa: F401  (the ops and their costs)
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models.params import (abstract_params, bytes_params, count_params,
                                       refresh_derived, tree_leaves, tree_paths)
from repro_torch.optim.adamw import OptConfig
from repro_torch.roofline import analysis, extrapolate, report

ROOT = Path(__file__).resolve().parents[1]
NAMES = sorted(JARCHS)

#: the counter against XLA's count of the same forward: XLA also counts the
#: masked half of a causal attention's scores (its flash source computes
#: every block) and a few elementwise ops more; 0.93-0.99 at these sizes
XLA_FLOPS_REL_TOL = 0.08


def _jax_path(cfg, port_path: str) -> tuple[str, bool]:
    """The JAX path of a port leaf, and whether JAX stacks it."""
    m = re.match(r"\['(layers|encoder|decoder)'\]\[(\d+)\](.*)", port_path)
    if m is None:
        return port_path, False
    group, i, rest = m.group(1), int(m.group(2)), m.group(3)
    if group != "layers":
        return f"['{group}']{rest}", True
    for s, seg in enumerate(jplan_segments(cfg)):
        n = seg.count * len(seg.kinds)
        if i < n:
            return f"['segments'][{s}]['{i % len(seg.kinds)}']{rest}", True
        i -= n
    raise AssertionError(port_path)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=jparams.is_spec)}


def _dtype(x) -> str:
    return str(jnp.dtype(x)) if not isinstance(x, torch.dtype) else str(x).removeprefix("torch.")


# ---------------------------------------------------------------------------
# hw.py
# ---------------------------------------------------------------------------


def test_chip_spec_has_jax_fields_by_name():
    jfields = {f.name: f for f in dataclasses.fields(jhw.ChipSpec)}
    fields = {f.name: f for f in dataclasses.fields(hw.ChipSpec)}
    # mxu_dim and clock_hz have no counterpart on the card (hw.py says why)
    assert set(jfields) - set(fields) == {"mxu_dim", "clock_hz"}
    for name in set(jfields) & set(fields):
        assert isinstance(getattr(hw.H100_SXM, name), type(getattr(jhw.TPU_V5E, name))), name
    chip = hw.DEFAULT_CHIP
    assert chip is hw.H100_SXM and chip.name == "NVIDIA H100 80GB HBM3"
    assert (chip.peak_bf16_flops, chip.peak_tf32_flops, chip.peak_f32_flops,
            chip.peak_int32_ops, chip.peak_fp8_flops, chip.peak_int8_ops) == (
        989e12, 495e12, 67e12, 33.5e12, 1979e12, 1979e12)
    assert (chip.hbm_bw, chip.sm_count, chip.vmem_bytes, chip.smem_per_sm_bytes) == (
        3.35e12, 132, 227 * 1024, 228 * 1024)
    assert chip.nvlink_bw == 18 * 25e9 and chip.nic_bw == 50e9 and chip.node_size == 8
    assert hw.MATMUL_PLAN_BYTES_S == 3.0e12


def test_chip_smoke_reads_hw():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert chip_smoke.HBM_BYTES_S == hw.H100_SXM.hbm_bw
    assert chip_smoke.BF16_TC_FLOPS == hw.H100_SXM.peak_bf16_flops
    assert chip_smoke.TF32_TC_FLOPS == hw.H100_SXM.peak_tf32_flops
    assert chip_smoke.F32_FLOPS == hw.H100_SXM.peak_f32_flops
    assert chip_smoke.INT32_OPS == chip_smoke.F32_FLOPS / 2


# ---------------------------------------------------------------------------
# configs, params and specs
# ---------------------------------------------------------------------------


def test_shapes_and_skip_set_equal_jax():
    assert sorted(SHAPES) == sorted(JSHAPES)
    for name in SHAPES:
        assert dataclasses.asdict(get_shape(name)) == dataclasses.asdict(jget_shape(name))
    with pytest.raises(KeyError):
        get_shape("decode_1m")
    for arch in NAMES:
        for shape in SHAPES:
            assert cell_supported(ARCHS[arch], SHAPES[shape]) == jcell_supported(
                JARCHS[arch], JSHAPES[shape]), (arch, shape)


@pytest.fixture(scope="module")
def model_pairs():
    return {n: (jbuild(JARCHS[n]), build_model(ARCHS[n], device="cpu")) for n in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_param_counts_and_abstract_params_equal_jax(model_pairs, name):
    jmodel, model = model_pairs[name]
    jtree, tree = jmodel.param_specs(), model.param_specs()
    assert count_params(tree) == jparams.count_params(jtree)
    assert bytes_params(tree) == jparams.bytes_params(jtree)
    jflat = _flat(jparams.abstract_params(jtree))
    got = abstract_params(tree)
    seen = set()
    for path, t in zip(tree_paths(got), tree_leaves(got)):
        jpath, stacked = _jax_path(ARCHS[name], path)
        js = jflat[jpath]
        seen.add(jpath)
        assert t.device.type == "meta"
        assert (tuple(t.shape), _dtype(t.dtype)) == (
            tuple(js.shape[1:] if stacked else js.shape), _dtype(js.dtype)), path
    assert seen == set(jflat)


@pytest.mark.parametrize("name", NAMES)
def test_batch_and_decode_specs_equal_jax(model_pairs, name):
    jmodel, model = model_pairs[name]
    for shape in SHAPES:
        want = jspecs.batch_specs(JARCHS[name], JSHAPES[shape])
        got = specs.batch_specs(ARCHS[name], SHAPES[shape])
        assert {k: (tuple(t.shape), _dtype(t.dtype)) for k, t in got.items()} == {
            k: (tuple(s.shape), _dtype(s.dtype)) for k, s in want.items()}
        jtok, jcache = jspecs.decode_specs(JARCHS[name], JSHAPES[shape], jmodel)
        tok, cache = specs.decode_specs(ARCHS[name], SHAPES[shape], model)
        assert (tuple(tok.shape), _dtype(tok.dtype)) == (tuple(jtok.shape), _dtype(jtok.dtype))
        assert tok.device.type == "meta"
        # JAX's per-segment stacked leaves hold the port's [L, ...] leaves between them
        jleaves = [(k.rsplit("['", 1)[1][:-2], s) for k, s in _flat(jcache).items()
                   if k != "['pos']"]
        for key, t in cache.items():
            if key == "pos":
                assert t.shape == () and t.dtype == torch.int32
                continue
            parts = [s for k, s in jleaves if k == key]
            assert sum(s.shape[0] for s in parts) == t.shape[0], key
            assert {(tuple(s.shape[1:]), _dtype(s.dtype)) for s in parts} == {
                (tuple(t.shape[1:]), _dtype(t.dtype))}, key


@pytest.mark.parametrize("name", NAMES)
def test_abstract_opt_state_equals_jax_eval_shape(model_pairs, name):
    jmodel, model = model_pairs[name]
    jopt = jspecs.pick_opt(JARCHS[name])
    opt = specs.pick_opt(ARCHS[name])
    assert dataclasses.asdict(jopt) == dataclasses.asdict(opt)
    jstate = jspecs.abstract_opt_state(jopt, jparams.abstract_params(jmodel.param_specs()))
    state = specs.abstract_opt_state(opt, abstract_params(model.param_specs()))
    assert (tuple(state["step"].shape), _dtype(state["step"].dtype)) == (
        tuple(jstate["step"].shape), _dtype(jstate["step"].dtype))
    jflat = _flat({"m": jstate["m"], "v": jstate["v"]})
    seen = set()
    for part in ("m", "v"):
        for path, t in zip(tree_paths(state[part]), tree_leaves(state[part])):
            leaf = path.rsplit("['", 1)[0] if path.endswith(
                ("['row']", "['col']", "['full']")) else path
            jpath, stacked = _jax_path(ARCHS[name], leaf)
            js = jflat[f"['{part}']{jpath}{path[len(leaf):]}"]
            seen.add(f"['{part}']{jpath}{path[len(leaf):]}")
            want = tuple(js.shape[1:] if stacked and js.shape else js.shape)
            assert t.device.type == "meta"
            assert (tuple(t.shape), _dtype(t.dtype)) == (want, _dtype(js.dtype)), (part, path)
    assert seen == set(jflat)


def test_abstract_opt_state_takes_a_ranks_slices():
    """With shardings, each leaf of the state is the rank's slice, and
    Adafactor factors a leaf by its global shape."""
    cfg = ARCHS["yi-9b"]
    model = build_model(cfg, device="cpu")
    with dryrun.fake_group(256):
        mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
        from repro_torch.dist.sharding import ShardingRules

        rules = ShardingRules.for_arch(cfg, mesh)
        shard = rules.sharding_tree(model.param_specs())
        params = abstract_params(model.param_specs(), shard)
        state = specs.abstract_opt_state(OptConfig(kind="adafactor"), params, shard)
    wq = params["layers"][0]["attn"]["wq"]
    assert tuple(wq.shape) == shard["layers"][0]["attn"]["wq"].local_shape((4096, 4096))
    v = state["v"]["layers"][0]["attn"]["wq"]
    assert tuple(v["row"].shape) == tuple(wq.shape[:-1])
    assert tuple(v["col"].shape) == tuple(wq.shape[-1:])


# ---------------------------------------------------------------------------
# collectives, model_flops, roofline_terms
# ---------------------------------------------------------------------------


def _hlo_line(kind: str, shape: tuple, group: int, form: str, phase: str) -> str:
    dims = ",".join(map(str, shape))
    out = f"bf16[{dims}]{{{','.join(str(i) for i in range(len(shape)))}}}"
    groups = (f"replica_groups=[{256 // group},{group}]<=[256]" if form == "iota" else
              "replica_groups={" + ",".join("{" + ",".join(str(g * group + i)
                                                              for i in range(group)) + "}"
                                            for g in range(256 // group)) + "}")
    if phase == "":
        return f"  %x = {out} {kind}(bf16[{dims}] %a), {groups}, dimensions={{0}}"
    if phase == "-start":
        return f"  %s = ({out}, {out}) {kind}-start(bf16[{dims}] %a), {groups}"
    return f"  %d = {out} {kind}-done(({out}, {out}) %s)"


@pytest.mark.parametrize("phase", ["", "-start", "-done"])
@pytest.mark.parametrize("form", ["iota", "list"])
@pytest.mark.parametrize("group", [2, 4, 16])
@pytest.mark.parametrize("kind", list(analysis.COLLECTIVE_OPS))
def test_collective_bytes_equals_jax_hlo_parse(kind, group, form, phase):
    shape = (group * 3, 1024)
    line = _hlo_line(kind, shape, group, form, phase)
    want = janalysis.collective_bytes_from_hlo(line)
    out_bytes = 2 * shape[0] * shape[1]
    # JAX halves a start's (in, out) tuple and skips the done; a permute
    # names no groups (its size, 2 by default, does not enter its cost)
    got = 0.0 if phase == "-done" else analysis.collective_bytes(
        kind, out_bytes, group if kind != "collective-permute" else 2)
    assert want["total"] == pytest.approx(got, rel=0, abs=0)
    two = janalysis.collective_bytes_from_hlo(line + "\n" + _hlo_line(
        kind, shape, group, form, "-done"))
    assert two["total"] == want["total"]
    with pytest.raises(ValueError):
        analysis.collective_bytes("broadcast", 1, 2)


@pytest.mark.parametrize("name", NAMES)
def test_model_flops_and_roofline_terms_equal_jax_up_to_the_constants(name):
    tpu, card = jhw.TPU_V5E, hw.H100_SXM
    for shape in SHAPES:
        assert analysis.model_flops(ARCHS[name], SHAPES[shape]) == janalysis.model_flops(
            JARCHS[name], JSHAPES[shape])
        kw = dict(flops_per_device=3.1e15, bytes_per_device=2.7e11,
                  collective_bytes_per_device=4.4e10, chips=256)
        want = janalysis.roofline_terms(**kw, cfg=JARCHS[name], shape=JSHAPES[shape])
        got = analysis.roofline_terms(**kw, cfg=ARCHS[name], shape=SHAPES[shape])
        assert set(got) == set(want)
        assert got["compute_s"] == pytest.approx(
            want["compute_s"] * tpu.peak_bf16_flops / card.peak_bf16_flops, rel=1e-12)
        assert got["memory_s"] == pytest.approx(want["memory_s"] * tpu.hbm_bw / card.hbm_bw,
                                                rel=1e-12)
        assert got["collective_s"] == pytest.approx(
            want["collective_s"] * tpu.ici_bw_per_link / card.nvlink_bw, rel=1e-12)
        for key in ("model_flops", "hlo_flops_global", "useful_flops_ratio"):
            assert got[key] == want[key]
        terms = {k: got[f"{k}_s"] for k in ("compute", "memory", "collective")}
        assert got["bottleneck"] == max(terms, key=terms.get)
        assert got["step_bound_s"] == max(terms.values())
        # the NIC's share of the traffic at its own rate
        nic = analysis.roofline_terms(**kw, cfg=ARCHS[name], shape=SHAPES[shape],
                                      nic_bytes_per_device=1e10)
        assert nic["collective_s"] == pytest.approx(3.4e10 / card.nvlink_bw + 1e10 / card.nic_bw)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_views_cost_nothing_and_the_peak_follows_frees():
    with analysis.CostCounter() as c:
        a = _meta(1000, dtype=torch.float32)
        b = a + 1                                  # 1000 FLOPs, 8000 bytes moved
        v = b.view(10, 100).t()
        assert c.by_op["add"] == [1, 1000.0, 8000.0]
        assert "view" not in c.by_op and "t" not in c.by_op
        del b
        gc.collect()
        assert c.live_bytes == 8000                # b lives on under its view
        del v
        gc.collect()
        assert c.live_bytes == 4000 and c.peak_bytes == 8000


def test_gathers_and_indexed_writes_move_rows_not_tables():
    table = _meta(50000, 64)
    idx = _meta(8, dtype=torch.int64)
    cache = _meta(8, 4, 4096, 64)
    slot, row = _meta(1, dtype=torch.int64), _meta(8, 4, 1, 64)
    with analysis.CostCounter() as c:
        torch.nn.functional.embedding(idx, table)
        cache.index_copy_(2, slot, row)
        s = cache.sum()
    assert c.by_op["embedding"][2] == 2 * 8 * 64 * 2 + 8 * 8
    assert c.by_op["index_copy_"][2] == 2 * (8 * 4 * 64 * 2) + 8
    assert c.by_op["sum"][1] == cache.numel()
    assert c.peak_bytes == 8 * 64 * 2 and s.shape == ()    # the lookup's rows, freed


def _cpu(*shape, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


def _cost(name, *args, **kwargs):
    impl = dispatch.resolve(name)
    out = impl.fn(*args, **kwargs)
    with analysis.CostCounter() as c:
        dispatch.op(name, *args, **kwargs)
    got = dispatch.COSTS[name](out, *args, **kwargs)
    assert c.by_op[name] == [1, float(got[0]), float(got[1])]
    assert c.flops == got[0] and c.bytes == got[1]     # nothing of the source is counted
    return got


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_matmul_cost_is_its_bound_formula(out_dtype):
    M, K, N = 8, 256, 96
    got = _cost("matmul", _cpu(M, K), _cpu(K, N), out_dtype=out_dtype)
    # chip_smoke.py's rows: 2(MK + KN + MN) bf16 out, 2(MK + KN) + 4MN f32 out
    out_b = 2 if out_dtype is None else 4
    assert got == (2 * M * N * K, 2 * (M * K + K * N) + out_b * M * N)


def test_rmsnorm_cost_is_its_bound_formula():
    R, D = 8, 2048
    assert _cost("rmsnorm", _cpu(R, D), _cpu(D)) == (4 * R * D, 2 * (2 * R * D + D))


@pytest.mark.parametrize("S,T,causal,window,D", [(64, 64, True, None, 64),
                                                  (16, 64, True, None, 64),
                                                  (48, 48, False, None, 32),
                                                  (64, 64, True, 24, 64)])
def test_flash_attention_cost_is_its_bound_formula(S, T, causal, window, D):
    Hq, Hkv = 4, 2
    q, k, v = _cpu(1, Hq, S, D), _cpu(1, Hkv, T, D, seed=1), _cpu(1, Hkv, T, D, seed=2)
    got = _cost("flash_attention", q, k, v, causal=causal, window=window)
    # chip_smoke.py's rows: 2(2·Hq·S·D + 2·Hkv·T·D) bytes, 4·Hq·D FLOPs a kept pair
    i = np.arange(S)[:, None] + T - S
    j = np.arange(T)[None, :]
    keep = np.ones((S, T), bool)
    if causal:
        keep &= j <= i
    if window:
        keep &= j > i - window
    assert got == (4 * Hq * D * int(keep.sum()), 2 * (2 * Hq * S * D + 2 * Hkv * T * D))


def test_mla_widths_flash_cost_is_its_bound_formula():
    H, S, DQK, DV = 4, 32, 48, 32
    got = _cost("flash_attention", _cpu(1, H, S, DQK), _cpu(1, H, S, DQK), _cpu(1, H, S, DV),
                causal=True, scale=DQK ** -0.5)
    # chip_smoke.py's <192,128> rows: 2·H·S·(2·DQK + 2·DV), 2·H·(DQK + DV) a kept pair
    assert got == (2 * H * (DQK + DV) * S * (S + 1) // 2, 2 * H * S * (2 * DQK + 2 * DV))


def test_decode_attention_costs_are_their_bound_formulas():
    B, Hq, Hkv, T, D = 3, 8, 2, 40, 64
    lengths = torch.tensor([1, 17, 40], dtype=torch.int32)
    got = _cost("decode_attention", _cpu(B, Hq, D), _cpu(B, Hkv, T, D, seed=1),
                _cpu(B, Hkv, T, D, seed=2), lengths)
    n = int(lengths.sum())
    # chip_smoke.py's rows: 2(2·B·Hq·D + 2·Hkv·n·D) bytes, 4·Hq·D·n FLOPs
    assert got == (4 * Hq * D * n, 2 * (2 * B * Hq * D + 2 * Hkv * n * D))
    # on meta the lengths are unknown: every row of the cache
    meta = dispatch.COSTS["decode_attention"](_meta(B, Hq, D), _meta(B, Hq, D),
                                              _meta(B, Hkv, T, D), _meta(B, Hkv, T, D),
                                              _meta(dtype=torch.int32))
    assert meta[0] == 4 * Hq * D * B * T
    NP, ps = 4, 16
    pool = NP * B + 1
    table = torch.arange(B * NP, dtype=torch.int32).reshape(B, NP)
    got = _cost("paged_decode_attention", _cpu(B, Hq, D), _cpu(pool, Hkv, ps, D, seed=1),
                _cpu(pool, Hkv, ps, D, seed=2), table, lengths)
    # and the table and lengths: + 4(B·NP + B)
    assert got == (4 * Hq * D * n, 2 * (2 * B * Hq * D + 2 * Hkv * n * D) + 4 * (B * NP + B))


def test_ssd_and_conv2d_costs_are_chip_smokes_work_formulas():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    B, S, H, P, G, N = 2, 40, 4, 16, 2, 32
    x = _cpu(B, S, H, P)
    a = -torch.rand(H)
    b, c = _cpu(B, S, G, N, seed=1), _cpu(B, S, G, N, seed=2)
    dt = torch.rand(B, S, H) * 0.1
    got = _cost("ssd", x, a, b, c, dt, chunk=16)
    want_bytes, want_flops = chip_smoke.ssd_work(S, B=B, H=H, P=P, G=G, N=N)
    assert got == (want_flops, want_bytes)
    xi = torch.randint(-5, 5, (1, 12, 10, 1), dtype=torch.int16)
    w = torch.randint(-3, 3, (3, 3, 1, 2), dtype=torch.int16)
    want_bytes, want_flops = chip_smoke.conv_work(1, 12, 10, 1, 3, 3, 2, 2)
    assert _cost("conv2d", xi, w) == (want_flops, want_bytes)


def test_an_op_without_a_cost_raises():
    dispatch.register_cost("matmul", dispatch.COSTS.pop("matmul"))
    saved = dispatch.COSTS.pop("rmsnorm")
    try:
        with pytest.raises(KeyError, match="no cost"), analysis.CostCounter():
            dispatch.op("rmsnorm", _meta(2, 8), _meta(8))
    finally:
        dispatch.register_cost("rmsnorm", saved)
    assert dispatch._observer is None


FAMILIES = ["llama3.2-1b", "internvl2-76b", "llama4-maverick-400b-a17b", "deepseek-v3-671b",
            "mamba2-780m", "hymba-1.5b", "whisper-large-v3"]


def _frontend(cfg, B, jax_side: bool):
    key = {"vision_patches": "patch_embeds", "audio_frames": "frames"}.get(cfg.frontend)
    if key is None:
        return {}
    shape = (B, cfg.frontend_seq, cfg.d_model)
    if jax_side:
        return {key: jax.ShapeDtypeStruct(shape, jnp.bfloat16)}
    return {key: _meta(*shape)}


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("name", FAMILIES)
def test_counted_flops_near_xla_cost_analysis(name, step):
    B, S = 2, 64
    jcfg, cfg = jreduced(JARCHS[name]), reduced(ARCHS[name])
    jm = jbuild(jcfg, unroll=True)
    p_abs = jparams.abstract_params(jm.param_specs())
    model = build_model(cfg, device="cpu")
    params = refresh_derived(abstract_params(model.param_specs()))
    with unroll_inner_loops():
        if step == "prefill":
            batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
                     **_frontend(jcfg, B, True)}
            lowered = jax.jit(lambda p, b: jm.prefill(p, b)).lower(p_abs, batch)
        else:
            lowered = jax.jit(lambda p, t, c: jm.decode_step(p, t, c)).lower(
                p_abs, jax.ShapeDtypeStruct((B, 1), jnp.int32), jm.cache_specs(B, S))
    ca = lowered.cost_analysis()
    want = (ca[0] if isinstance(ca, list) else ca)["flops"]
    with torch.no_grad(), analysis.CostCounter() as c:
        if step == "prefill":
            model.prefill(params, {"tokens": _meta(B, S, dtype=torch.int32),
                                   **_frontend(cfg, B, False)})
        else:
            model.decode_step(params, _meta(B, 1, dtype=torch.int32),
                              abstract_params(model.cache_specs(B, S)))
    ratio = c.flops / want
    print(f"{name} {step}: counted {c.flops:.6g}, XLA {want:.6g}, ratio {ratio:.4f}")
    assert abs(ratio - 1) <= XLA_FLOPS_REL_TOL, ratio


@pytest.mark.parametrize("name", ["llama3.2-1b", "deepseek-v3-671b", "hymba-1.5b",
                                  "whisper-large-v3"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_extrapolation_equals_the_direct_count(name, kind):
    """The affine fit over depth, at the real counts, equals the count of
    the full-depth step: every layer is counted where it runs."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.sharding import ShardingRules

    cfg = reduced(ARCHS[name])
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, num_layers=4, moe=dataclasses.replace(
            cfg.moe, first_k_dense=1))
    else:
        cfg = dataclasses.replace(cfg, num_layers=3)
    shape = ShapeConfig(name=f"tiny_{kind}", seq_len=32, global_batch=2, kind=kind)
    with dryrun.fake_group(1):
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        rules = ShardingRules.for_arch(cfg, mesh, serving=kind != "train")
        direct = dryrun.count_step(cfg, shape, rules)["counter"]
        fit = extrapolate.extrapolated_costs(cfg, shape, rules)
    assert fit["variants"] == (3 if cfg.family == "audio" else 1 + len(
        extrapolate.plan_segments(cfg)))
    for key, want in (("flops", direct.flops), ("bytes", direct.bytes),
                      ("coll", direct.collective_bytes)):
        assert fit[key] == pytest.approx(want, rel=1e-9, abs=1e-6), key
    assert fit["flops_outside"] > 0 and all(v > 0 for v in fit["flops_per_segment"])


def test_extrapolation_keeps_the_full_models_optimizer(monkeypatch):
    """A shallow variant's own parameter count may pick another optimizer
    than the full model's (internvl2-76b: AdamW at 1 and 2 layers,
    Adafactor at 80); the variants run the full model's, so the fit stays
    the direct count."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.sharding import ShardingRules

    def by_depth(cfg):
        return OptConfig(kind="adafactor" if cfg.num_layers >= 3 else "adamw")

    monkeypatch.setattr(dryrun, "pick_opt", by_depth)
    monkeypatch.setattr(specs, "pick_opt", by_depth)
    cfg = dataclasses.replace(reduced(ARCHS["llama3.2-1b"], d_model=256), num_layers=3)
    shape = ShapeConfig(name="tiny_train", seq_len=32, global_batch=4, kind="train")
    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        rules = ShardingRules.for_arch(cfg, mesh)
        direct = dryrun.count_step(cfg, shape, rules, microbatches=2)["counter"]
        fit = extrapolate.extrapolated_costs(cfg, shape, rules, microbatches=2)
    assert "rsqrt" in direct.by_op                       # Adafactor's factored statistics
    for key, want in (("flops", direct.flops), ("bytes", direct.bytes),
                      ("coll", direct.collective_bytes)):
        assert fit[key] == pytest.approx(want, rel=1e-9), key


# ---------------------------------------------------------------------------
# report.py
# ---------------------------------------------------------------------------


def _records() -> list[dict]:
    rng = np.random.default_rng(5)
    out = []
    for arch in ("yi-9b", "mamba2-780m", "deepseek-v3-671b"):
        for shape in ("train_4k", "decode_32k", "long_500k"):
            for mesh in ("16x16", "2x16x16"):
                if shape == "long_500k" and arch != "mamba2-780m":
                    out.append({"arch": arch, "shape": shape, "mesh": mesh, "status": "skip",
                                "reason": "long_500k requires sub-quadratic attention"})
                    continue
                if arch == "deepseek-v3-671b" and mesh == "2x16x16":
                    out.append({"arch": arch, "shape": shape, "mesh": mesh, "status": "fail",
                                "error": "RuntimeError: something"})
                    continue
                t = rng.uniform(1e-4, 3.0, 3)
                out.append({"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                            "compile_s": float(rng.uniform(0, 30)),
                            "memory": {"argument_bytes": int(rng.integers(1, 1 << 36)),
                                       "temp_bytes": int(rng.integers(1, 1 << 34))},
                            "collectives": {"all-reduce": float(rng.uniform(0, 1e10)),
                                            "all-gather": float(rng.uniform(0, 1e10))},
                            "roofline": {"compute_s": t[0], "memory_s": t[1],
                                         "collective_s": t[2], "bottleneck": "memory",
                                         "roofline_fraction": t[0] / t.max(),
                                         "useful_flops_ratio": float(rng.uniform(0, 1))}})
    return out


def test_report_tables_equal_jax(tmp_path):
    recs = _records()
    assert report.dryrun_table(recs) == jreport.dryrun_table(recs)
    assert report.roofline_table(recs) == jreport.roofline_table(recs)
    single, multi = tmp_path / "a.json", tmp_path / "b.json"
    single.write_text(json.dumps([r for r in recs if r["mesh"] == "16x16"]))
    multi.write_text(json.dumps([r for r in recs if r["mesh"] != "16x16"]))
    assert report.summarize(str(single), str(multi)) == jreport.summarize(str(single),
                                                                          str(multi))
