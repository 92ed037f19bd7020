"""The port's training stack against the JAX package's, on the CPU: the
optimizers, the data pipeline, checkpoints, the loop, the step and the
launcher; the derived f32 copies and the refusal of kernels with no
backward pass.

- ``opt_update`` against JAX's for 5 steps, AdamW and Adafactor with
  ``b1 = 0.9`` and ``0``, on a tree of bf16 and f32 leaves of rank 1, 2
  (factored: both sides at least 128; and not) and 3, the learning rate
  across warmup and decay, the gradients clipped on some steps and not
  others: the learning rate within 1e-6 relative (an ulp of XLA's
  cosine), the global norm within 1e-5 (f32 sums in another order), f32
  leaves and every f32 moment within 1e-5 relative L2, bf16 leaves and
  momenta within four bf16 steps (2^-5 relative) of JAX's element by
  element and equal on at least 99 % of them;
- ``batch_at`` bitwise JAX's; the checkpoint round trip (bf16 bitwise),
  latest and retention, an interrupted write unseen, a shape or path
  mismatch refused; the loop's resume, NaN guard, straggler and
  preemption, as ``tests/test_substrate.py`` holds JAX's;
- ``make_train_step`` against JAX's on a 1x1 mesh: reduced llama in f32,
  3 steps, each parameter leaf within 1e-5 relative L2 (its update within
  1e-4); 2 microbatches equal 1 (gradients
  within 1e-6 relative L2, the loss within 1e-6); ``auto_microbatches``
  equal JAX's;
- the launcher's 2 steps on the CPU and its resume from the checkpoint.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jlayers
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.dist.sharding import ShardingRules
from repro.launch.mesh import make_mesh
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.core.registry import KernelImpl, KernelRegistry
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, make_batch_iterator
from repro_torch.examples import train_lm
from repro_torch.launch import specs
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, init_params, layers, params_from_jax
from repro_torch.models.params import refresh_derived, trainable, tree_leaves, tree_paths
from repro_torch.optim.adamw import OptConfig, lr_schedule, opt_init, opt_update
from repro_torch.train import step as tstep
from repro_torch.train.loop import LoopConfig, TrainLoop


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_l2(got, want) -> float:
    g, w = _np32(got).astype(np.float64), _np32(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

#: (shape, dtype): rank 1; rank 2 factored (both sides >= 128) and not; rank 3
#: factored (the last two) and not
OPT_LEAVES = {"norm": ((300,), "bfloat16"), "proj": ((160, 130), "float32"),
              "embed": ((130, 20), "bfloat16"), "experts": ((3, 128, 136), "bfloat16"),
              "small": ((3, 5, 7), "float32")}
#: gradient scales a step: the global norm passes the clip at 1.0 on some
OPT_GRAD_SCALES = (0.002, 0.05, 0.0005, 0.02, 0.003)


def _opt_tree(rng):
    arrs = {k: rng.normal(size=shape).astype(np.float32) * 0.5 for k, (shape, _) in
            OPT_LEAVES.items()}
    jt = {k: jnp.asarray(a, getattr(jnp, OPT_LEAVES[k][1])) for k, a in arrs.items()}
    tt = {k: torch.from_numpy(np.asarray(jt[k], np.float32)).to(getattr(torch, OPT_LEAVES[k][1]))
          for k in arrs}
    return jt, tt


def _bf16_close(got: torch.Tensor, want) -> None:
    """Within four bf16 steps (2^-5 relative) of JAX's element by element,
    and equal on at least 99 % of the elements: the two orders of f32
    operations put a rounding boundary on either side now and then, and
    Adafactor's bf16 momentum carries such a step into the next."""
    g, w = _np32(got), _np32(want)
    np.testing.assert_allclose(g, w, rtol=2 ** -5, atol=1e-6 * float(np.abs(w).max()))
    assert float(np.mean(g == w)) >= 0.99


@pytest.mark.parametrize("kind,b1", [("adamw", 0.9), ("adafactor", 0.9), ("adafactor", 0.0)])
def test_optimizer_matches_jax_over_five_steps(kind, b1):
    cfg = dict(kind=kind, lr=0.01, warmup_steps=2, decay_steps=4, b1=b1, grad_clip=1.0)
    jcfg, tcfg = jadamw.OptConfig(**cfg), OptConfig(**cfg)
    rng = np.random.default_rng(7)
    jp, tp = _opt_tree(rng)
    js, ts = jadamw.opt_init(jcfg, jp), opt_init(tcfg, tp)
    clipped = []
    for step, scale in enumerate(OPT_GRAD_SCALES):
        grads = {k: rng.normal(size=shape).astype(np.float32) * scale * (1 + i)
                 for i, (k, (shape, _)) in enumerate(OPT_LEAVES.items())}
        jg = {k: jnp.asarray(g, jp[k].dtype) for k, g in grads.items()}
        tg = {k: torch.from_numpy(np.asarray(jg[k], np.float32)).to(tp[k].dtype) for k in grads}
        jp, js, jm = jadamw.opt_update(jcfg, jp, jg, js)
        tp, ts, tm = opt_update(tcfg, tp, tg, ts)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert _rel_l2(tm["lr"], jm["lr"]) <= 1e-6, step
        assert _rel_l2(tm["grad_norm"], jm["grad_norm"]) <= 1e-5, step
        clipped.append(float(jm["grad_norm"]) > 1.0)
        for k, (_, dtype) in OPT_LEAVES.items():
            assert tp[k].dtype == getattr(torch, dtype)
            if dtype == "float32":
                assert _rel_l2(tp[k], jp[k]) <= 1e-5, (step, k)
            else:
                _bf16_close(tp[k], jp[k])
        for k in OPT_LEAVES:
            for part, want in js["v"][k].items() if kind == "adafactor" else (("v", js["v"][k]),):
                got = ts["v"][k][part] if kind == "adafactor" else ts["v"][k]
                assert tuple(got.shape) == want.shape and _rel_l2(got, want) <= 1e-5, (step, k)
            got, want = ts["m"][k], js["m"][k]
            assert tuple(got.shape) == want.shape and got.dtype == getattr(torch, str(want.dtype))
            if got.dtype == torch.bfloat16 and got.dim():
                _bf16_close(got, want)
            else:
                assert _rel_l2(got, want) <= 1e-5, (step, k)
    assert any(clipped) and not all(clipped)


def test_lr_schedule_matches_jax_across_warmup_and_decay():
    cfg = dict(lr=3e-4, warmup_steps=5, decay_steps=20, min_lr_frac=0.1)
    jcfg, tcfg = jadamw.OptConfig(**cfg), OptConfig(**cfg)
    for s in range(0, 26):
        want = float(jadamw.lr_schedule(jcfg, jnp.asarray(s, jnp.int32)))
        got = float(lr_schedule(tcfg, torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s


@pytest.mark.parametrize("kind,b1", [("adamw", 0.9), ("adafactor", 0.9), ("adafactor", 0.0)])
def test_optimizers_reduce_quadratic(kind, b1):
    """``tests/test_substrate.py``'s check: 30 steps on mean(w^2)."""
    cfg = OptConfig(kind=kind, lr=0.1, warmup_steps=1, decay_steps=200, weight_decay=0.0, b1=b1)
    params = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(256, 256))).float()}
    state = opt_init(cfg, params)
    loss0 = float(torch.mean(params["w"] ** 2))
    for _ in range(30):
        params, state, m = opt_update(cfg, params, {"w": 2 * params["w"] / params["w"].numel()},
                                      state)
    assert float(torch.mean(params["w"] ** 2)) < 0.2 * loss0
    assert np.isfinite(float(m["grad_norm"]))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_pick_opt_matches_jax(name):
    from repro.launch.specs import pick_opt as jpick_opt

    assert dataclasses.asdict(specs.pick_opt(ARCHS[name])) == dataclasses.asdict(
        jpick_opt(JARCHS[name]))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed", [(1000, 64, 4, 3), (128256, 256, 8, 0),
                                                  (50, 130, 3, 9)])
def test_batch_at_is_bitwise_jax(vocab, seq, batch, seed):
    j = JSyntheticTokens(JDataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch,
                                     seed=seed))
    t = SyntheticTokens(DataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed))
    for step in (0, 1, 17):
        want, got = j.batch_at(step)["tokens"], t.batch_at(step)["tokens"]
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_batch_iterator_resumes_at_its_start_step():
    cfg = DataConfig(vocab_size=1000, seq_len=128, global_batch=4, seed=1, repeat_prob=1.0)
    src = SyntheticTokens(cfg)
    it = make_batch_iterator(cfg, start_step=5, device="cpu", prefetch=2)
    for step in range(5, 9):
        batch = next(it)
        assert batch["tokens"].dtype == torch.int32
        assert np.array_equal(batch["tokens"].numpy(), src.batch_at(step)["tokens"])
    toks = src.batch_at(0)["tokens"]
    np.testing.assert_array_equal(toks[:, :64], toks[:, 64:128])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
            "nested": {"b": torch.from_numpy(rng.integers(0, 9, (3,)).astype(np.int32)),
                       "c": [torch.from_numpy(rng.normal(size=(5,))).to(torch.bfloat16),
                             torch.tensor(7, dtype=torch.int32)]}}


def test_checkpoint_roundtrip_is_bitwise(tmp_path):
    tree = _tree()
    # every bf16 bit pattern, NaNs and infinities among them
    tree["bits"] = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    path = save_checkpoint(str(tmp_path), 7, tree)
    restored, manifest = restore_checkpoint(path, tree)
    assert manifest["step"] == 7
    assert [e["key"] for e in manifest["entries"]] == tree_paths(tree)
    assert "['nested']['c'][0]" in tree_paths(tree)
    for got, want in zip(tree_leaves(restored), tree_leaves(tree)):
        assert got.dtype == want.dtype and got.shape == want.shape
        if want.dtype == torch.bfloat16:
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        else:
            assert torch.equal(got, want)


def test_checkpoint_latest_and_retention(tmp_path):
    tree = _tree()
    for step in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), step, tree, keep=2)
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000005")
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(kept) == 2


def test_checkpoint_interrupted_write_is_invisible(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_00000009.tmp")      # a writer killed mid-flight
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000001")
    assert latest_checkpoint(str(tmp_path / "absent")) is None


def test_checkpoint_shape_or_path_mismatch_rejected(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 1, tree)
    bad = _tree()
    bad["a"] = torch.zeros((2, 2))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, bad)
    renamed = {"z": tree["a"], "nested": tree["nested"]}
    with pytest.raises(ValueError, match="where"):
        restore_checkpoint(path, renamed)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(path, {"a": tree["a"]})


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def _toy_step():
    def step(params, opt_state, batch):
        params = {k: p - 0.1 * batch["g"] for k, p in params.items()}
        return params, opt_state, {"loss": torch.sum(params["w"] ** 2)}
    return step


def test_loop_checkpoint_and_resume(tmp_path):
    params = {"w": torch.ones(4)}
    cfg = LoopConfig(total_steps=10, ckpt_dir=str(tmp_path), ckpt_every=5, log_every=0)

    def batch_at(s):
        return {"g": torch.full((4,), 0.01)}

    p1, _, rep1 = TrainLoop(_toy_step(), batch_at, cfg, log=lambda s: None).run(params, {})
    assert rep1.steps_run == 10
    # a restarted job resumes from step 10 and does nothing more
    p2, _, rep2 = TrainLoop(_toy_step(), batch_at, cfg, log=lambda s: None).run(params, {})
    assert rep2.resumed_from == 10 and rep2.steps_run == 0
    assert torch.equal(p1["w"], p2["w"])
    # more total steps continue from the checkpoint
    cfg3 = dataclasses.replace(cfg, total_steps=14)
    _, _, rep3 = TrainLoop(_toy_step(), batch_at, cfg3, log=lambda s: None).run(params, {})
    assert rep3.resumed_from == 10 and rep3.steps_run == 4


def test_loop_nan_guard(tmp_path):
    def bad_step(params, opt_state, batch):
        return params, opt_state, {"loss": torch.tensor(float("nan"))}

    cfg = LoopConfig(total_steps=3, ckpt_dir=str(tmp_path), ckpt_every=1, log_every=0)
    with pytest.raises(FloatingPointError):
        TrainLoop(bad_step, lambda s: {}, cfg, log=lambda s: None).run({"w": torch.ones(2)}, {})
    assert latest_checkpoint(str(tmp_path)) is None      # never checkpointed


def test_loop_straggler_detection():
    import time

    def slow_step(params, opt_state, batch):
        if batch["i"] == 7:
            time.sleep(0.25)
        return params, opt_state, {"loss": torch.tensor(1.0)}

    loop = TrainLoop(slow_step, lambda s: {"i": s},
                     LoopConfig(total_steps=12, log_every=0, straggler_factor=3.0),
                     log=lambda s: None)
    _, _, report = loop.run({"w": torch.ones(2)}, {})
    assert 7 in report.stragglers


def test_loop_preemption_checkpoints(tmp_path):
    cfg = LoopConfig(total_steps=100, ckpt_dir=str(tmp_path), ckpt_every=1000, log_every=0)
    loop = TrainLoop(_toy_step(), lambda s: {"g": torch.full((4,), 0.01)}, cfg,
                     log=lambda s: None)
    orig = loop.step_fn

    def step_then_preempt(params, opt_state, batch):
        out = orig(params, opt_state, batch)
        loop._preempt = True            # SIGTERM arriving
        return out

    loop.step_fn = step_then_preempt
    _, _, report = loop.run({"w": torch.ones(4)}, {})
    assert report.preempted and report.steps_run == 1
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000001")


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _llama_pair(f32: bool):
    jcfg, cfg = jreduced(JARCHS["llama3.2-1b"]), reduced(ARCHS["llama3.2-1b"])
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(0))
    if f32:
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    model = build_model(cfg, device="cpu")
    params = trainable(params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    return jmodel, jparams, model, params


def _tokens(cfg, step: int, B: int = 4, S: int = 32) -> np.ndarray:
    return np.random.default_rng(step).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_train_step_matches_jax_on_a_1x1_mesh():
    """Reduced llama in f32, 3 steps of AdamW from the same weights and
    batches: every parameter leaf within 1e-5 relative L2 of JAX's, the
    three steps' update within 1e-4, the loss and grad norm of each step
    within 1e-5 relative."""
    jmodel, jparams, model, params = _llama_pair(f32=True)
    start = params
    opt = dict(kind="adamw", lr=1e-3, warmup_steps=1, decay_steps=10)
    mesh = make_mesh((1, 1), ("data", "model"))
    rules = ShardingRules.for_arch(jmodel.cfg, mesh)
    old = jlayers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE
    jlayers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE = jnp.float32, torch.float32
    try:
        with jax.set_mesh(mesh):
            jfn, *_ = jstep.make_train_step(jmodel, jadamw.OptConfig(**opt), rules,
                                            global_batch=4, donate=False)
            jstate = jadamw.opt_init(jadamw.OptConfig(**opt), jparams)
            step = tstep.make_train_step(model, OptConfig(**opt), device="cpu")
            state = opt_init(OptConfig(**opt), params)
            for s in range(3):
                toks = _tokens(model.cfg, s)
                jparams, jstate, jm = jfn(jparams, jstate, {"tokens": jnp.asarray(toks)})
                params, state, m = step(params, state, {"tokens": torch.from_numpy(toks)})
                for key in ("loss", "grad_norm"):
                    assert _rel_l2(m[key], jm[key]) <= 1e-5, (s, key)
    finally:
        jlayers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE = old
    want = trainable(params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    for key, got, w, p0 in zip(tree_paths(want), tree_leaves(params), tree_leaves(want),
                               tree_leaves(start)):
        # the update alone: Adam's m / sqrt(v) amplifies f32 rounding where
        # m cancels (one element of wd in 32768 moves 1.4e-5 apart)
        assert _rel_l2(got, w) <= 1e-5, key
        assert _rel_l2(_np32(got) - _np32(p0), _np32(w) - _np32(p0)) <= 1e-4, key


def test_two_microbatches_equal_one():
    _, _, model, params = _llama_pair(f32=True)
    toks = torch.from_numpy(_tokens(model.cfg, 0))
    old = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        loss, metrics, whole = tstep.value_and_grad(model, params, {"tokens": toks})
        acc, mb_metrics = tstep.microbatched_grads(model, params, {"tokens": toks}, 2,
                                                   torch.float32)
        opt = OptConfig(kind="adamw", lr=1e-3, warmup_steps=1, decay_steps=10)
        state = opt_init(opt, params)
        p1, _, _ = tstep.make_train_step(model, opt, device="cpu")(params, state,
                                                                    {"tokens": toks})
        p2, _, _ = tstep.make_train_step(model, opt, microbatches=2, device="cpu")(
            params, state, {"tokens": toks})
    finally:
        layers.COMPUTE_DTYPE = old
    assert abs(float(mb_metrics["loss"]) - float(loss)) <= 1e-6 * abs(float(loss))
    for key, g, w in zip(tree_paths(whole), tree_leaves(acc), tree_leaves(whole)):
        assert g.dtype == torch.float32 and _rel_l2(g, w) <= 1e-6, key
    for key, a, b in zip(tree_paths(p1), tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(_np32(a), _np32(b), rtol=0, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_auto_microbatches_matches_jax(name):
    mesh = make_mesh((1, 1), ("data", "model"))
    rules = ShardingRules.for_arch(JARCHS[name], mesh)
    for batch, seq in ((8, 1024), (256, 4096), (6, 32768), (1, 8192)):
        want = jstep.auto_microbatches(batch, seq, rules, cfg=JARCHS[name],
                                       stack_budget_bytes=4e9)
        got = tstep.auto_microbatches(batch, seq, cfg=ARCHS[name], stack_budget_bytes=4e9)
        assert got == want, (batch, seq)
    assert tstep.auto_microbatches(64, 2048, stack_budget_bytes=4e9) == jstep.auto_microbatches(
        64, 2048, rules, stack_budget_bytes=4e9)


def test_a_step_then_serving_reads_the_new_table():
    """After a step updates ``tok``, serving on ``refresh_derived`` weights
    gives the logits of the new table read directly; on the old copy (the
    state before the refresh) it does not."""
    model = build_model(reduced(ARCHS["llama3.2-1b"]), device="cpu")
    served = init_params(model.param_specs(), 3, device="cpu")
    params = trainable(served)
    assert set(params["embed"]) == {"tok"} and "tok_f32" in served["embed"]
    opt = OptConfig(kind="adamw", lr=1e-2, warmup_steps=1)
    toks = torch.from_numpy(_tokens(model.cfg, 1))
    new, _, _ = tstep.make_train_step(model, opt, device="cpu")(params, opt_init(opt, params),
                                                                {"tokens": toks})
    assert not torch.equal(new["embed"]["tok"], params["embed"]["tok"])
    with torch.no_grad():
        want, _ = model.prefill(new, {"tokens": toks})             # reads tok itself
        stale = {**new, "embed": {**new["embed"], "tok_f32": served["embed"]["tok_f32"]}}
        got_stale, _ = model.prefill(stale, {"tokens": toks})
        refreshed = refresh_derived(new)
        assert torch.equal(refreshed["embed"]["tok_f32"], new["embed"]["tok"].float())
        got, _ = model.prefill(refreshed, {"tokens": toks})
    assert torch.equal(got, want)
    assert not torch.allclose(got_stale, want, rtol=1e-3, atol=1e-3)


def test_training_tree_is_jax_leaves_with_storage_of_their_own():
    jmodel, jparams, model, _ = _llama_pair(f32=False)
    served = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    params = trainable(served)
    # JAX's stacked leaves, layer by layer, and no derived copy
    assert sum(t.numel() for t in tree_leaves(params)) == sum(
        a.size for a in jax.tree.leaves(jparams))
    assert [p for p in tree_paths(served) if p not in tree_paths(params)] == [
        "['embed']['tok_f32']"]
    ptrs = [t.untyped_storage().data_ptr() for t in tree_leaves(params)]
    assert len(set(ptrs)) == len(ptrs)
    # a layer's leaf written in place leaves the next layer's as it was
    before = params["layers"][1]["attn"]["wq"].clone()
    params["layers"][0]["attn"]["wq"].add_(1.0)
    assert torch.equal(params["layers"][1]["attn"]["wq"], before)
    # the optimizer and the global norm see the training tree's leaves only
    state = opt_init(OptConfig(), params)
    assert len(tree_leaves(state["m"])) == len(tree_leaves(params))


# ---------------------------------------------------------------------------
# no silent loss of gradient
# ---------------------------------------------------------------------------


def test_dispatch_refuses_a_kernel_with_no_backward_where_grad_flows():
    """A stand-in ``cuda`` matmul (its output detached, as a kernel's
    binding returns it) in a scratch registry: refused where an argument
    requires grad and grad is on; run under ``no_grad``, on tensors that
    require no grad, and where the ``torch`` source is preferred."""
    reg = KernelRegistry()
    reg.register(KernelImpl(op="matmul", device_kind="any", source="cuda",
                            fn=lambda x, w: (x @ w).detach()))
    reg.register(KernelImpl(op="matmul", device_kind="any", source="torch",
                            fn=lambda x, w: x @ w))
    x = torch.ones(2, 3, requires_grad=True)
    w = torch.ones(3, 4)
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict"), registry=reg):
        with pytest.raises(RuntimeError, match="no backward pass"):
            dispatch.op("matmul", x, w)
        with pytest.raises(RuntimeError, match="no backward pass"):
            dispatch.op("matmul", x=w.t(), w=x.t())
        with torch.no_grad():
            assert dispatch.op("matmul", x, w).sum() == 24
        assert dispatch.op("matmul", x.detach(), w).sum() == 24
    with dispatch.use(prefer=dispatch.policy_from_flag("torch"), registry=reg):
        dispatch.op("matmul", x, w).sum().backward()
    assert torch.equal(x.grad, torch.full((2, 3), 4.0))


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------


def test_launcher_trains_two_steps_then_resumes(tmp_path, capsys):
    args = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--global-batch", "4",
            "--seq", "32", "--ckpt-dir", str(tmp_path)]
    assert launch_train.main([*args, "--steps", "2"]) == 0
    first = capsys.readouterr().out
    assert "done: 2 steps from step 0" in first
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000002")
    assert launch_train.main([*args, "--steps", "3"]) == 0
    second = capsys.readouterr().out
    assert "resumed from" in second and "done: 1 steps from step 2" in second
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000003")


def test_launcher_refuses_a_mesh():
    """A 2x2 mesh needs four processes (``torchrun``); one process alone
    is refused before anything is built."""
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
                           "--mesh", "2x2"])


def test_example_trains_and_checkpoints(tmp_path, capsys):
    assert train_lm.main(["--steps", "2", "--batch", "2", "--seq", "32", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path)]) == 0
    assert "done: 2 steps" in capsys.readouterr().out
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000002")
