"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, with no card.

A decode cell of every configuration at 16x16 and at 2x16x16 runs in a
subprocess of its own (rank 0 of 256 or 512 under the ``fake`` backend, on
meta tensors), as ``--arch ... --shape decode_32k --both-meshes --out``
would: every record ``ok``, with JAX's keys, its arguments' bytes the
rank's slices exactly, the decode cache its aliased output.  In this
process: the fake group made and destroyed around a cell even when the
cell raises (a ``fail`` record); JAX's skips; the deepseek-v3 decode on
meta tensors (MLA's latent write takes a scalar position by
``index_copy_``, no host read), and that write's bits against indexing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as JARCHS
from repro.roofline import analysis as janalysis
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.models.mla import write_latent
from repro_torch.models.params import abstract_params, refresh_derived

ROOT = Path(__file__).resolve().parents[1]
NAMES = sorted(JARCHS)
RECORD_KEYS = {"arch", "shape", "mesh", "status", "chips", "kind", "lower_s", "compile_s",
               "flops_per_device", "bytes_per_device", "collective_bytes_per_device",
               "scan_measured", "extrapolation", "collectives", "memory", "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "code_bytes"}


@pytest.fixture(scope="module")
def decode_records(tmp_path_factory):
    """Every configuration's decode_32k cell on both production meshes, in
    one subprocess (its process groups die with it)."""
    out = tmp_path_factory.mktemp("dryrun") / "decode.json"
    code = (
        "import json, sys\n"
        "from repro_torch.configs import ARCHS\n"
        "from repro_torch.launch import dryrun\n"
        "recs = [dryrun.lower_cell(a, 'decode_32k', multi_pod=mp, verbose=False, "
        "with_cost=False) for a in sorted(ARCHS) for mp in (False, True)]\n"
        f"open({str(out)!r}, 'w').write(json.dumps(recs))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {(r["arch"], r["mesh"]): r for r in json.loads(out.read_text())}


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("name", NAMES)
def test_decode_cell_counts_one_rank(decode_records, name, mesh):
    rec = decode_records[(name, mesh)]
    assert rec["status"] == "ok", rec
    assert RECORD_KEYS <= set(rec) and MEMORY_KEYS <= set(rec["memory"])
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s", "bottleneck",
                                    "model_flops", "hlo_flops_global", "useful_flops_ratio",
                                    "step_bound_s", "roofline_fraction"}
    assert rec["chips"] == (256 if mesh == "16x16" else 512) and rec["kind"] == "decode"
    m = rec["memory"]
    assert m["argument_bytes"] == m["param_bytes"] + m["input_bytes"] and m["code_bytes"] == 0
    assert m["opt_state_bytes"] == 0
    # the cache is updated in place: an output that is an input
    assert 0 < m["alias_bytes"] < m["output_bytes"] <= m["alias_bytes"] + 128 * 2 ** 20
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > m["param_bytes"] / 4
    assert rec["roofline"]["model_flops"] == janalysis.model_flops(
        JARCHS[name], _jshape("decode_32k"))
    # a 16-rank model axis spans two 8-card nodes: its traffic goes over the NIC
    assert rec["collective_bytes_per_device"] >= rec["nic_bytes_per_device"] > 0


def _jshape(name):
    from repro.configs import SHAPES

    return SHAPES[name]


def test_the_two_meshes_hold_the_same_weights_a_rank(decode_records):
    """Serving rules place weights over the model axis only: one rank holds
    the same slices on both meshes (the pod axis splits the batch)."""
    for name in NAMES:
        a, b = decode_records[(name, "16x16")], decode_records[(name, "2x16x16")]
        assert a["memory"]["param_bytes"] == b["memory"]["param_bytes"], name


def test_a_cell_that_raises_is_a_fail_record_and_leaves_no_group(tmp_path, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "count_step", boom)
    out = tmp_path / "cells.json"
    rc = dryrun.main(["--arch", "yi-9b", "--shape", "decode_32k", "--out", str(out)])
    assert rc == 1 and not dist.is_initialized()
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "fail" and "planted" in rec["error"]
    # a skip needs no group at all, and an existing record is not run again
    rc = dryrun.main(["--arch", "yi-9b", "--shape", "long_500k", "--out", str(out)])
    assert rc == 0 and not dist.is_initialized()
    recs = json.loads(out.read_text())
    assert [r["status"] for r in recs] == ["fail", "skip"]
    assert recs[1]["reason"].startswith("long_500k requires sub-quadratic attention")


def test_skips_are_jaxs():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import cell_supported as jcell_supported

    for name in NAMES:
        for shape in JSHAPES:
            ok, _ = jcell_supported(JARCHS[name], JSHAPES[shape])
            rec = None if ok else dryrun.lower_cell(name, shape, multi_pod=False,
                                                    verbose=False)
            assert ok or rec["status"] == "skip", (name, shape)


def test_reduced_deepseek_decode_runs_on_meta_tensors():
    """MLA's decode wrote its latent row by indexing with a 0-d tensor, a
    host read (which a meta tensor cannot give, and which costs the card a
    sync a layer); it now writes by index_copy_."""
    cfg = reduced(ARCHS["deepseek-v3-671b"])
    model = build_model(cfg, device="cpu")
    params = refresh_derived(abstract_params(model.param_specs()))
    cache = abstract_params(model.cache_specs(2, 32))
    tokens = torch.empty((2, 1), dtype=torch.int32, device="meta")
    with torch.no_grad():
        logits, new = model.decode_step(params, tokens, cache)
    assert logits.device.type == "meta" and tuple(logits.shape) == (2, cfg.vocab_size)
    rec = dryrun.count_on_one_rank(cfg, ShapeConfig("tiny", 32, 2, "decode"))
    assert rec["status"] == "ok" and rec["flops_per_device"] > 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("pos", [0, 5, 37, torch.tensor([3, 31, 32, 40])])
def test_write_latent_bits_equal_indexing(pos):
    g = torch.Generator().manual_seed(1)
    cache = torch.randn((4, 32, 24), generator=g).to(torch.bfloat16)
    new = torch.randn((4, 24), generator=g)
    want = cache.clone()
    p = torch.as_tensor(pos)
    slot = p % 32
    if slot.dim() == 0:
        want[:, int(slot)] = new.to(want.dtype)
    else:
        want[torch.arange(4), slot] = new.to(want.dtype)
    write_latent(cache, new, p)
    assert torch.equal(cache, want)


def test_a_sharded_prefill_grows_by_its_cache_a_layer():
    """Rank 0 of 16x16 prefilling 32 x 256 tokens of llama3.2-1b at 1 and 2
    layers: the counted peak grows by one layer's cache on this rank (k and
    v for its 2 sequences, all 8 kv heads, 256 rows of 64) and nothing
    more; the prefill step's global cache shapes are specs, not tensors
    the counter would take for live memory."""
    import dataclasses

    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    shape = ShapeConfig("prefill_256", 256, 32, "prefill")
    prod = make_production_mesh(multi_pod=False)
    peaks = []
    for layers in (1, 2):
        cfg = dataclasses.replace(ARCHS["llama3.2-1b"], num_layers=layers)
        with dryrun.fake_group(prod.size):
            mesh = make_mesh(prod.dims, prod.axis_names, device="cpu")
            rules = ShardingRules.for_arch(cfg, mesh, serving=True)
            peaks.append(dryrun.count_step(cfg, shape, rules)["counter"].peak_bytes)
    assert not dist.is_initialized()
    assert peaks[1] - peaks[0] == 2 * (32 // 16) * 8 * 256 * 64 * 2
