"""The port's sharded paths on a (2, 2) mesh of four gloo processes, held
against the JAX package's single-device results on the same weights, at
the bounds of ``tests/test_distributed.py`` (f32, reduced configs; the
rank bodies are ``tests/torch_dist_ranks.py``, started once for the file):

- the sharded train step (llama3.2-1b, mamba2-780m, hymba-1.5b): ``nll``
  within 5e-4 of JAX's loss; the grad norm within 1e-5 relative and every
  updated leaf within 1e-4 relative L2 of the port's one-device step (the
  gradients' sums run in another order, and Adam's first update
  ``g / (|g| + eps)`` magnifies that where a gradient is near zero: a
  hymba leaf of zeros moves 3.4e-5 apart);
- expert parallelism: EP all_to_all (deepseek, 8 experts, top-4, capacity
  factor 8) and EP tp (llama4) within 2e-4 of JAX's ``apply_moe``, nothing
  dropped, the aux metrics within 1e-5 of JAX's shard_map bodies' (each
  rank's tokens routed by JAX's ``_route``, the mean over the mesh), and
  every routed leaf's gradient of
  ``sum(y * r)`` within 1e-4 relative L2 of the port's one-device one;
  serving decode (llama4, top-1) within 2e-4: 6 experts with their FFN
  over data, and 8, which cover the mesh (held over the model axis, taken
  over data x model: each rank gathers its experts);
- the sharded prefill and decode steps: the prefill's and 4 decode steps'
  logits within 2e-4 of JAX's ``prefill``/``decode_step`` for yi-9b (one
  k/v head: sequence-parallel decode, the cache a time slice a rank),
  hymba-1.5b (a window's ring and SSM state, gathered each layer),
  mamba2-780m and deepseek-v3 (MLA latents; MoE decode with experts over
  data x model), every cache leaf in its placement's local shape;
- ``compressed_psum`` over the data axis within ``max|x| / 64`` of the
  true mean, its residual exactly ``x - dequant(quant(x))``;
- a checkpoint saved at 2x2 restored at 1x4 and at one rank, bitwise;
- ``launch/train.py --mesh 2x2 --reduced --device cpu``: two steps, the
  first loss within 5e-4 of the 1x1 run's.
"""

from __future__ import annotations

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models.params import init_params as jinit_params
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, layers, params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models.params import trainable, tree_leaves
from repro_torch.optim.adamw import OptConfig, opt_init
from repro_torch.train.step import make_train_step

from torch_dist_ranks import run_ranks

TRAIN_ARCHS = ("llama3.2-1b", "mamba2-780m", "hymba-1.5b")
OPT = dict(kind="adamw", lr=1e-3, warmup_steps=1, decay_steps=10)
LAUNCH = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--steps", "2",
          "--global-batch", "4", "--seq", "32"]
#: serving under rules: (weights' seed, MoE overrides; capacity factor 8
#: so that per-shard capacity drops nothing, as tests/test_distributed.py)
SERVE_ARCHS = {"yi-9b": (2, None), "hymba-1.5b": (3, None), "mamba2-780m": (4, None),
               "deepseek-v3-671b": (5, dict(capacity_factor=8.0))}
MOE_CASES = {
    "ep_all": ("deepseek-v3-671b", dict(num_experts=8, experts_per_token=4, capacity_factor=8.0),
               (4, 8), False, True),
    "ep_tp": ("llama4-maverick-400b-a17b",
              dict(num_experts=4, experts_per_token=1, capacity_factor=8.0), (4, 8), False, True),
    "ff_over_data": ("llama4-maverick-400b-a17b",
                     dict(num_experts=6, experts_per_token=1, capacity_factor=8.0), (4, 1), True,
                     False),
    "experts_over_mesh": ("llama4-maverick-400b-a17b",
                          dict(num_experts=8, experts_per_token=1, capacity_factor=8.0), (4, 1),
                          True, False),
}


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


class _F32:
    def __enter__(self):
        self.old = jlayers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE
        jlayers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE = jnp.float32, torch.float32

    def __exit__(self, *exc):
        jlayers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE = self.old


def _train_inputs(want: dict) -> dict:
    """Each arch's f32 weights and batch; JAX's single-device loss and the
    port's one-device step beside them."""
    out = {}
    for arch in TRAIN_ARCHS:
        jcfg = jreduced(JARCHS[arch])
        jmodel = jbuild_model(jcfg)
        jparams = _f32(jinit_params(jmodel.param_specs(), jax.random.key(0)))
        tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
        with _F32():
            loss, _ = jax.jit(jmodel.loss)(jparams, {"tokens": jnp.asarray(tokens)})
            model = build_model(reduced(ARCHS[arch]), device="cpu")
            params = trainable(params_from_jax(_np_tree(jparams), device="cpu"))
            opt = OptConfig(**OPT)
            new, _, metrics = make_train_step(model, opt, device="cpu")(
                params, opt_init(opt, params), {"tokens": torch.from_numpy(tokens)})
        out[arch] = {"params": _np_tree(jparams), "tokens": tokens, "opt": OPT}
        want[arch] = {"loss": float(loss), "grad_norm": float(metrics["grad_norm"]),
                      "leaves": [t.float().numpy() for t in tree_leaves(new)]}
    return out


def _moe_inputs(name: str, want: dict) -> dict:
    arch, moe_cfg, (B, S), dropless, grad = MOE_CASES[name]
    jcfg = jreduced(JARCHS[arch])
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_cfg))
    p = _f32(jinit_params(jmoe.moe_specs(jcfg), jax.random.key(0)))
    routed = _np_tree({"router": p["router"], "experts": p["experts"]})
    x = np.asarray(jax.random.normal(jax.random.key(1), (B, S, jcfg.d_model), jnp.float32))
    r = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    y, _ = jax.jit(jmoe._moe_local, static_argnums=(2, 3))(
        jnp.asarray(x).reshape(B * S, -1), routed, jcfg.moe, dropless)
    # JAX's shard_map bodies route each rank's tokens and average the aux
    # terms over the mesh: EP-all's ranks hold (data rows, sequence slice),
    # tp's the data rows (the same on both model ranks), serving decode all
    if name == "ep_all":
        shards = [x[2 * d:2 * d + 2, S // 2 * m:S // 2 * (m + 1)] for d in (0, 1) for m in (0, 1)]
    elif name == "ep_tp":
        shards = [x[2 * d:2 * d + 2] for d in (0, 1)]
    else:
        shards = [x]
    route = jax.jit(jmoe._route, static_argnums=2)
    auxes = [route(jnp.asarray(t).reshape(-1, jcfg.d_model), routed["router"], jcfg.moe)[2]
             for t in shards]
    want[name] = {"y": np.asarray(y).reshape(B, S, -1),
                  "aux": {k: float(np.mean([a[k] for a in auxes])) for k in auxes[0]}}
    if grad:
        # the port's one-device gradients of sum(y * r)
        cfg = reduced(ARCHS[arch])
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_cfg))
        tp = {"router": torch.from_numpy(routed["router"]).requires_grad_(True),
              "experts": {k: torch.from_numpy(v).requires_grad_(True)
                          for k, v in routed["experts"].items()}}
        with _F32():
            ty, _ = tmoe.apply_moe(tp, torch.from_numpy(x), cfg, dropless=dropless)
        (ty * torch.from_numpy(r)).sum().backward()
        want[name]["grads"] = [t.grad.numpy() for t in (tp["router"], *tp["experts"].values())]
    return {"arch": arch, "moe": moe_cfg, "params": routed, "x": x, "r": r, "grad": grad}


def _serve_inputs(want: dict) -> dict:
    """Each serving arch's f32 weights and tokens; JAX's one-device prefill
    and decode logits."""
    out = {}
    for arch, (seed, moe_cfg) in SERVE_ARCHS.items():
        jcfg = jreduced(JARCHS[arch])
        if moe_cfg:
            jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_cfg))
        jmodel = jbuild_model(jcfg)
        jparams = _f32(jinit_params(jmodel.param_specs(), jax.random.key(seed)))
        S, extra, CL = 8, 4, 16
        toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                                 (4, S + extra)).astype(np.int32)
        with _F32():
            lg, cache = jax.jit(functools.partial(jmodel.prefill, cache_len=CL))(
                jparams, {"tokens": jnp.asarray(toks[:, :S])})
            refs = [np.asarray(lg)]
            decode = jax.jit(jmodel.decode_step)
            for t in range(extra):
                lg, cache = decode(jparams, jnp.asarray(toks[:, S + t:S + t + 1]), cache)
                refs.append(np.asarray(lg))
        want[f"serve/{arch}"] = refs
        out[arch] = {"params": _np_tree(jparams), "tokens": toks, "S": S, "cache_len": CL,
                     "moe": moe_cfg}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """JAX's results and the inputs, then every case in four ranks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want: dict = {}
        ckpt_cfg = jreduced(JARCHS["llama3.2-1b"])
        inputs = {
            "launcher": {"argv": [*LAUNCH, "--mesh", "2x2"]},
            "train": _train_inputs(want),
            **{name: _moe_inputs(name, want) for name in MOE_CASES},
            "serve": _serve_inputs(want),
            "compressed_psum": {"x": np.asarray(jax.random.normal(jax.random.key(0), (4, 64),
                                                                  jnp.float32))},
            "checkpoint": {"arch": "llama3.2-1b", "opt": "adamw", "params": jax.tree.map(
                np.asarray, jinit_params(jbuild_model(ckpt_cfg).param_specs(),
                                         jax.random.key(3)))},
        }
        got = run_ranks(inputs, tmp_path_factory.mktemp("ranks"))
    finally:
        torch.set_num_threads(threads)
    return inputs, want, got


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_matches_jax_loss_and_one_device_update(ranks, arch):
    _, want, got = ranks
    one, ref = got["train"][arch], want[arch]
    assert abs(one["nll"] - ref["loss"]) <= 5e-4 + 5e-4 * abs(ref["loss"]), (one["nll"], ref)
    assert abs(one["grad_norm"] - ref["grad_norm"]) <= 1e-5 * ref["grad_norm"]
    assert len(one["leaves"]) == len(ref["leaves"])
    for i, (g, w) in enumerate(zip(one["leaves"], ref["leaves"])):
        assert g.shape == w.shape and _rel_l2(g, w) <= 1e-4, (arch, i, _rel_l2(g, w))


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_expert_parallel_moe_matches_jax(ranks, name):
    _, want, got = ranks
    one, ref = got[name], want[name]
    assert one["mode"] == ("all" if name == "ep_all" else "tp")
    np.testing.assert_allclose(one["y"], ref["y"], rtol=2e-4, atol=2e-4)
    assert one["aux"]["dropped_frac"] == 0.0
    for key in ("load_balance", "router_z"):
        assert abs(one["aux"][key] - ref["aux"][key]) <= 1e-5 * abs(ref["aux"][key]), key
    for i, (g, w) in enumerate(zip(one.get("grads", ()), ref.get("grads", ()))):
        assert _rel_l2(g, w) <= 1e-4, (name, i, _rel_l2(g, w))


@pytest.mark.parametrize("arch", sorted(SERVE_ARCHS))
def test_sharded_serving_steps_match_jax(ranks, arch):
    _, want, got = ranks
    one = got["serve"][arch]
    # yi-9b's one k/v head: sequence-parallel decode, [L, B, Hkv, T, hd] with
    # the batch over data and the time axis over model; the others gather
    # their split cache leaves (a window's ring, SSM state, MLA latents)
    assert one["sp"] == [arch == "yi-9b"] * 4
    assert one["cache_shapes"] == one["want_shapes"]
    if arch == "yi-9b":
        assert one["cache_shapes"]["k"] == (2, 2, 1, 8, 32)
    for t, (g, w) in enumerate(zip(one["logits"], want[f"serve/{arch}"])):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4, err_msg=f"{arch} step {t}")


def test_compressed_psum_over_the_data_axis(ranks):
    inputs, _, got = ranks
    x = inputs["compressed_psum"]["x"]
    true_mean = x.reshape(2, 2, 64).mean(axis=0)
    one = got["compressed_psum"]
    assert one["residual_exact"]
    assert np.abs(one["y"] - true_mean).max() < np.abs(x).max() / 64


def test_checkpoint_saved_at_2x2_restores_at_1x4_and_one_rank_bitwise(ranks):
    inputs, _, got = ranks
    one = got["checkpoint"]
    assert one["mesh_shape"] == [2, 2]
    for g, w in zip(one["restored"] + one["restored_state"], one["saved"] + one["saved_state"]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    like = trainable(params_from_jax(inputs["checkpoint"]["params"], device="cpu"))
    opt = OptConfig(kind="adamw")
    (params, state), _ = restore_checkpoint(one["path"], (like, opt_init(opt, like)))
    whole = [t.float().numpy() for t in tree_leaves(params) + tree_leaves(state)]
    for g, w in zip(whole, one["saved"] + one["saved_state"]):
        assert np.array_equal(g, w)


def _losses(out: str) -> list[float]:
    return [float(v) for v in re.findall(r"\[loop\] step \d+ loss ([0-9.]+)", out)]


def test_launcher_trains_on_a_2x2_mesh_as_on_1x1(ranks, capsys):
    _, _, got = ranks
    out = got["launcher"]["out"]
    assert "mesh=2x2" in out and "done: 2 steps from step 0" in out
    assert launch_train.main([*LAUNCH, "--mesh", "1x1"]) == 0
    one = capsys.readouterr().out
    assert abs(_losses(out)[0] - _losses(one)[0]) <= 5e-4, (out, one)
