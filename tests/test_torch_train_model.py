"""The port's training forward (``DecoderLM.loss``, ``forward``,
``EncDecLM.loss``, ``chunked_ce``, remat) against the JAX package's, on the
CPU.

Every family of ``tests/test_models.py``'s ``ALL_ARCHS`` (dense, vlm,
llama4 and deepseek MoE, deepseek's MLA, mamba2, hymba, whisper), reduced
with its ``_smoke_cfg`` (MoE capacity factor 8), weights from
``jax.random.key(0)`` carried across with ``params_from_jax``, tokens (and
frames or patch embeddings) drawn with numpy.  JAX runs under its default
policy ``("xla", "reference")`` (its training policy), the port under
``torch``:

- in f32 (``COMPUTE_DTYPE`` patched on both packages, the parameters cast,
  as ``tests/test_models.py`` does): the loss within 1e-5 relative, every
  gradient leaf (mapped with ``params_from_jax``) within 1e-4 relative L2,
  the aux metrics (``load_balance``, ``router_z`` within 1e-5 relative,
  ``dropped_frac`` exactly), ``forward``'s logits within 1e-4; the tied
  unembed's gradient reaches every row of ``tok``;
- in bf16: the loss within 2e-2 relative;
- ``chunked_ce`` where ``S - 1`` is not a multiple of the chunk (the padded
  tail masked), tied and untied, loss and gradients within 1e-5;
- ``remat`` ``none``, ``full`` and ``dots`` give the same gradients, bit
  for bit.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jlayers
import repro.models.model as jmodel_mod
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import dispatch as jdispatch
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.models import build_model, layers, params_from_jax
from repro_torch.models import model as model_mod
from repro_torch.models.params import trainable, tree_map

ALL_ARCHS = sorted(JARCHS)
LOSS_F32, LEAF_F32, LOSS_BF16 = 1e-5, 1e-4, 2e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _smoke_cfgs(name: str):
    """``tests/test_models.py``'s ``_smoke_cfg`` in both packages."""
    jcfg, cfg = jreduced(JARCHS[name]), reduced(ARCHS[name])
    if jcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=8.0))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _batch(cfg, B: int = 2, S: int = 16, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        batch["patch_embeds"] = rng.normal(size=(B, cfg.frontend_seq, cfg.d_model)).astype(
            np.float32)
    if cfg.frontend == "audio_frames":
        batch["frames"] = rng.normal(size=(B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return batch


def _leaves(tree, prefix: str = "") -> dict:
    """Leaves by their path, ``/embed/tok``, ``/layers/0/ln1``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    return {k: v for key, sub in items for k, v in _leaves(sub, f"{prefix}/{key}").items()}


def _f32_jax(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a, tree)


class _ComputeDtype:
    """Both packages' ``COMPUTE_DTYPE`` set for the block."""

    def __init__(self, f32: bool):
        self.f32 = f32

    def __enter__(self):
        self.old = jlayers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE
        if self.f32:
            jlayers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE = jnp.float32, torch.float32

    def __exit__(self, *exc):
        jlayers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE = self.old


def _jax_value_and_grad(jmodel, jparams, batch):
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jdispatch.use(prefer=("xla", "reference")):
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: jmodel.loss(p, jbatch), has_aux=True)(jparams)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _port_value_and_grad(model, params, batch):
    tree = tree_map(lambda t: t.detach().clone().requires_grad_(True), trainable(params))
    leaves = _leaves(tree)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with dispatch.use(prefer=("torch", "reference")):
        loss, metrics = model.loss(tree, tbatch)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return (float(loss.detach()), {k: float(v) for k, v in metrics.items()},
            dict(zip(leaves, grads)), tree)


def _setup(name: str, f32: bool):
    jcfg, cfg = _smoke_cfgs(name)
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(0))
    if f32:
        jparams = _f32_jax(jparams)
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, model, params, _batch(cfg)


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_loss_and_every_gradient_leaf_match_jax_in_f32(name):
    jmodel, jparams, model, params, batch = _setup(name, f32=True)
    with _ComputeDtype(f32=True):
        jloss, jmetrics, jgrads = _jax_value_and_grad(jmodel, jparams, batch)
        loss, metrics, grads, _ = _port_value_and_grad(model, params, batch)
    assert _rel(loss, jloss) <= LOSS_F32, (loss, jloss)
    for key in ("load_balance", "router_z"):
        assert _rel(metrics[key], jmetrics[key]) <= LOSS_F32 or metrics[key] == jmetrics[key] == 0
    assert metrics["dropped_frac"] == jmetrics["dropped_frac"]
    assert _rel(metrics["nll"], jmetrics["nll"]) <= LOSS_F32
    want = _leaves(trainable(params_from_jax(jax.tree.map(np.asarray, jgrads), device="cpu")))
    assert set(want) == set(grads)
    for key, w in want.items():
        g = grads[key]
        assert g is not None and g.dtype == w.dtype and g.shape == w.shape, key
        err = float((g.double() - w.double()).norm())
        ref = float(w.double().norm())
        assert err <= LEAF_F32 * ref, (key, err, ref)
    tok = grads["/embed/tok"]
    if "unembed" not in params["embed"]:
        # the tied unembed reaches every row, not only the batch's tokens
        assert bool((tok.abs().sum(dim=1) > 0).all())
    assert float(tok.norm()) > 0


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_loss_matches_jax_in_bf16(name):
    jmodel, jparams, model, params, batch = _setup(name, f32=False)
    jloss, jmetrics, _ = _jax_value_and_grad(jmodel, jparams, batch)
    loss, metrics, grads, tree = _port_value_and_grad(model, params, batch)
    assert _rel(loss, jloss) <= LOSS_BF16, (loss, jloss)
    leaves = _leaves(tree)
    for key, g in grads.items():
        assert g is not None and g.dtype == leaves[key].dtype, key
        assert bool(torch.isfinite(g).all()), key


@pytest.mark.parametrize("name", [n for n in ALL_ARCHS if JARCHS[n].family != "audio"])
def test_forward_logits_match_jax_in_f32(name):
    jmodel, jparams, model, params, batch = _setup(name, f32=True)
    with _ComputeDtype(f32=True):
        with jdispatch.use(prefer=("xla", "reference")):
            want, jaux = jmodel.forward(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        with dispatch.use(prefer=("torch", "reference")), torch.no_grad():
            got, aux = model.forward(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert set(aux) == set(jaux) == set(model_mod.AUX_KEYS)
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("S,chunk", [(16, 4), (16, 16), (21, 8)])
def test_chunked_ce_matches_jax_with_a_padded_tail(tied, S, chunk):
    """``S - 1`` rows (15, 15, 20) in chunks of 4, 16 and 8: padded to 16,
    16 and 24, the tail masked; the loss and its gradients in ``h`` and the
    table (or the untied unembed) equal JAX's."""
    rng = np.random.default_rng(S * chunk)
    B, d, V = 3, 32, 50
    h = rng.normal(size=(B, S, d)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    embed = {"tok": (0.1 * rng.normal(size=(V, d))).astype(np.float32)}
    if not tied:
        embed["unembed"] = (0.1 * rng.normal(size=(d, V))).astype(np.float32)

    def jloss(e, x):
        return jmodel_mod.chunked_ce(e, x, jnp.asarray(labels), chunk=chunk)

    with jdispatch.use(prefer=("xla", "reference")):
        want, (jg_e, jg_h) = jax.value_and_grad(jloss, argnums=(0, 1))(
            {k: jnp.asarray(v) for k, v in embed.items()}, jnp.asarray(h))
    te = {k: torch.from_numpy(v).requires_grad_(True) for k, v in embed.items()}
    th = torch.from_numpy(h).requires_grad_(True)
    with dispatch.use(prefer=("torch", "reference")):
        got = model_mod.chunked_ce(te, th, torch.from_numpy(labels), chunk=chunk)
    got.backward()
    assert _rel(float(got.detach()), float(want)) <= 1e-5
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jg_h), rtol=1e-5, atol=1e-7)
    for k in embed:
        # an untied table is not read: no gradient (JAX's is zeros)
        g = te[k].grad if te[k].grad is not None else torch.zeros_like(te[k])
        np.testing.assert_allclose(g.numpy(), np.asarray(jg_e[k]), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["llama3.2-1b", "whisper-large-v3", "llama4-maverick-400b-a17b"])
def test_remat_modes_give_the_same_gradients(name):
    """The same loss and gradient leaves, bit for bit, whether each layer
    keeps its activations (``none``), only its input (``full``) or its
    matmul outputs too (``dots``)."""
    _, cfg = _smoke_cfgs(name)
    out = {}
    for mode in ("none", "full", "dots"):
        model = build_model(dataclasses.replace(cfg, remat=mode), device="cpu")
        _, jparams, _, params, batch = _setup(name, f32=False)
        loss, _, grads, _ = _port_value_and_grad(model, params, batch)
        out[mode] = loss, grads
    for mode in ("full", "dots"):
        assert out[mode][0] == out["none"][0]
        for key, g in out["none"][1].items():
            assert torch.equal(out[mode][1][key], g), (mode, key)


def test_remat_recomputes_under_the_forward_dispatch_context():
    """A checkpointed layer recomputed in the backward pass, outside the
    forward's ``dispatch.use`` block (as on another thread, where the
    context is unset), runs under the forward's context: its trace records
    every layer's ops a second time, in order."""
    _, cfg = _smoke_cfgs("llama3.2-1b")
    model = build_model(dataclasses.replace(cfg, remat="full"), device="cpu")
    _, _, _, params, batch = _setup("llama3.2-1b", f32=False)
    tree = tree_map(lambda t: t.detach().clone().requires_grad_(True), trainable(params))
    trace = dispatch.DispatchTrace()
    with dispatch.use(prefer=("torch", "reference"), trace=trace):
        loss, _ = model.loss(tree, {k: torch.from_numpy(v) for k, v in batch.items()})
    forward = list(trace.events)
    loss.backward()
    # the layers' ops (all but the final norm's), recomputed last to first
    layer_ops = forward[:-1]
    per_layer = len(layer_ops) // cfg.num_layers
    recomputed = trace.events[len(forward):]
    want = [op for i in reversed(range(cfg.num_layers))
            for op in layer_ops[i * per_layer:(i + 1) * per_layer]]
    assert forward[-1][0] == "rmsnorm" and recomputed == want
