"""Rank bodies for ``tests/test_torch_dist_ranks.py``: the port's sharded
paths on a (2, 2) mesh of four gloo processes on the CPU.

:func:`run_ranks` starts four processes (the ``spawn`` method; each joins
the group through a file under the test's ``tmp_path``, one torch thread
each), runs every case of :data:`CASES` in them in order, and returns what
rank 0 collected: numpy arrays and numbers, keyed by case.  The inputs
(weights and data the parent drew, and the JAX package's results are not
here: the parent compares) come in through a pickle the parent wrote.
Nothing here imports JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import multiprocessing as mp
import os
import pickle
import traceback

import numpy as np

WORLD = 4
TIMEOUT_S = 240


def run_ranks(inputs: dict, tmp_path) -> dict:
    """Every case in four rank processes; rank 0's results."""
    src = tmp_path / "inputs.pkl"
    src.write_bytes(pickle.dumps(inputs))
    out = tmp_path / "results.pkl"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, str(tmp_path))) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    errors = [f.read_text() for f in sorted(tmp_path.glob("rank*.err"))]
    if alive or errors or any(p.exitcode for p in procs):
        raise AssertionError(f"rank processes failed (exit codes "
                             f"{[p.exitcode for p in procs]}):\n" + "\n".join(errors))
    return pickle.loads(out.read_bytes())


def _rank(rank: int, tmp: str) -> None:
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=WORLD)
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        results = {}
        for name, case in CASES:
            if name in inputs:
                results[name] = case(inputs[name], tmp)
        if rank == 0:
            with open(os.path.join(tmp, "results.pkl"), "wb") as f:
                pickle.dump(results, f)
        dist.barrier()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# helpers (inside a rank)
# ---------------------------------------------------------------------------


def _mesh(shape=(2, 2)):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, ("data", "model"), device="cpu")


@contextlib.contextmanager
def _f32():
    from repro_torch.models import layers

    old, layers.COMPUTE_DTYPE = layers.COMPUTE_DTYPE, __import__("torch").float32
    try:
        yield
    finally:
        layers.COMPUTE_DTYPE = old


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _local(tree, shardings):
    from repro_torch.models.params import tree_flatten_as, tree_leaves, tree_unflatten

    return tree_unflatten(tree, [sh.local(x).clone() for x, sh in
                                 zip(tree_leaves(tree), tree_flatten_as(tree, shardings))])


def _gathered(tree, shardings) -> list[np.ndarray]:
    from repro_torch.models.params import tree_flatten_as, tree_leaves

    return [_np(sh.gather(x)) for x, sh in zip(tree_leaves(tree), tree_flatten_as(tree,
                                                                                 shardings))]


def _torch_tree(tree):
    import torch

    from repro_torch.models.params import tree_map

    return tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32)), tree)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def case_launcher(inp: dict, tmp: str) -> dict:
    """``launch/train.py --mesh 2x2`` through its ``main``: rank 0's
    printed lines."""
    from repro_torch.launch import train as launch_train

    os.environ["WORLD_SIZE"] = str(WORLD)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert launch_train.main(inp["argv"]) == 0
    return {"out": buf.getvalue()}


def case_train(inp: dict, tmp: str) -> dict:
    """One sharded train step per arch from the given f32 weights: nll,
    grad norm and every updated leaf gathered whole."""
    import torch

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.models.params import trainable
    from repro_torch.optim.adamw import OptConfig, opt_init
    from repro_torch.train.step import make_train_step

    mesh = _mesh()
    out = {}
    with _f32():
        for arch, one in inp.items():
            cfg = reduced(ARCHS[arch])
            model = build_model(cfg, device="cpu")
            rules = ShardingRules.for_arch(cfg, mesh)
            opt = OptConfig(**one["opt"])
            step, p_sh, _, _ = make_train_step(model, opt, rules, global_batch=4)
            params = _local(trainable(params_from_jax(one["params"], device="cpu")), p_sh)
            state = opt_init(opt, params, shardings=p_sh)
            new, _, metrics = step(params, state, {"tokens": torch.from_numpy(one["tokens"])})
            out[arch] = {"nll": float(metrics["nll"]), "grad_norm": float(metrics["grad_norm"]),
                         "leaves": _gathered(new, p_sh)}
    return out


def _moe_case(inp: dict, serving: bool, for_decode: bool, dropless: bool) -> dict:
    """``apply_moe`` under a layout: its output gathered whole and, where
    ``inp["grad"]``, the gradients of ``sum(y * r)`` for every routed
    leaf, gathered whole (a whole leaf's summed over the batch's ranks,
    as the train step sums it)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.dist import act
    from repro_torch.dist.collectives import gather
    from repro_torch.dist.sharding import Sharding, ShardingRules
    from repro_torch.models import moe
    from repro_torch.train.step import moe_mesh_info

    mesh = _mesh()
    cfg = reduced(ARCHS[inp["arch"]])
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **inp["moe"]))
    rules = ShardingRules.for_arch(cfg, mesh, serving=serving)
    info = moe_mesh_info(cfg, rules, for_decode=for_decode)
    specs = moe.moe_specs(cfg)
    whole = _torch_tree(inp["params"])
    shard = {"router": Sharding(mesh, rules.pspec(specs["router"])),
             "experts": {k: Sharding(mesh, rules.pspec(s)) for k, s in
                         specs["experts"].items()}}
    p = {"router": shard["router"].local(whole["router"]).clone(),
         "experts": {k: shard["experts"][k].local(v).clone()
                     for k, v in whole["experts"].items()}}
    leaves = [p["router"], *p["experts"].values()]
    for t in leaves:
        t.requires_grad_(inp["grad"])
    x = torch.from_numpy(inp["x"])
    batch = rules.batch_axes(x.shape[0])
    rows = Sharding(mesh, rules.batch_pspec(x.shape[0], 2))
    with _f32(), act.use_rules(rules), act.use_layout(act.StepLayout(batch_axes=batch)):
        y, aux = moe.apply_moe(p, rows.local(x), cfg, mesh_info=info, dropless=dropless)
    res = {"mode": info.mode, "y": _np(gather(y.detach(), 0, mesh.group(batch))),
           "aux": {k: float(v) for k, v in aux.items()}}
    if inp["grad"]:
        (y * rows.local(torch.from_numpy(inp["r"]))).sum().backward()
        grads = []
        for t, sh in zip(leaves, [shard["router"], *shard["experts"].values()]):
            g = t.grad.clone()
            used = {a for e in sh.entries for a in ((e,) if isinstance(e, str) else e or ())}
            group = mesh.group(tuple(a for a in batch if a not in used))
            if group is not None:
                dist.all_reduce(g, group=group)
            grads.append(_np(sh.gather(g)))
        res["grads"] = grads
    return res


def case_ep_all(inp: dict, tmp: str) -> dict:
    return _moe_case(inp, serving=False, for_decode=False, dropless=False)


def case_ep_tp(inp: dict, tmp: str) -> dict:
    return _moe_case(inp, serving=False, for_decode=False, dropless=False)


def case_ff_over_data(inp: dict, tmp: str) -> dict:
    return _moe_case(inp, serving=True, for_decode=True, dropless=True)


def case_experts_over_mesh(inp: dict, tmp: str) -> dict:
    return _moe_case(inp, serving=True, for_decode=True, dropless=True)


def case_serve(inp: dict, tmp: str) -> dict:
    """Each arch served sharded under serving rules: the prefill step's
    logits and each decode step's, the cache's local shapes against its
    placement's, and whether each decode step ran sequence-parallel."""
    import torch

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.dist import act
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.models import build_model, layers, params_from_jax
    from repro_torch.models.params import refresh_derived, trainable
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    mesh = _mesh()
    out = {}
    for arch, one in inp.items():
        cfg = reduced(ARCHS[arch])
        if one["moe"]:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **one["moe"]))
        model = build_model(cfg, device="cpu")
        rules = ShardingRules.for_arch(cfg, mesh, serving=True)
        S, CL = one["S"], one["cache_len"]
        toks = torch.from_numpy(one["tokens"])
        with _f32():
            pre, p_sh, _ = make_prefill_step(model, rules, global_batch=4, cache_len=CL)
            dec, _, c_sh, _ = make_decode_step(model, rules, global_batch=4, cache_len=CL)
            # this rank's slices of the trained leaves, the f32 copies made from them
            params = refresh_derived(_local(trainable(params_from_jax(one["params"],
                                                                      device="cpu")), p_sh))
            logits, cache = pre(params, {"tokens": toks[:, :S]})
            logits_out = [_np(logits)]
            shapes = {k: tuple(v.shape) for k, v in cache.items()}
            sp = []
            layout = act.StepLayout(cache={k: s.entries for k, s in c_sh.items()})
            for t in range(toks.shape[1] - S):
                with act.use_rules(rules), act.use_layout(layout):
                    sp.append(layers.sp_decode_applies(cfg, cache["pos"]))
                logits, cache = dec(params, toks[:, S + t:S + t + 1], cache)
                logits_out.append(_np(logits))
        out[arch] = {"logits": logits_out, "cache_shapes": shapes, "sp": sp,
                     "want_shapes": {k: s.local_shape(model.cache_specs(4, CL)[k].shape)
                                     for k, s in c_sh.items()}}
    return out


def case_compressed_psum(inp: dict, tmp: str) -> dict:
    """``compressed_psum`` over the data axis of each rank's rows."""
    import torch

    from repro_torch.dist.collectives import compressed_psum, dequantize_int8, quantize_int8

    mesh = _mesh()
    x = torch.from_numpy(inp["x"]).reshape(2, 2, -1)[mesh.index("data")]
    y, res = compressed_psum(x, mesh.group("data"))
    q, scale, shape = quantize_int8(x)
    want_res = x - dequantize_int8(q, scale, shape)
    return {"y": _np(y), "residual_exact": bool(torch.equal(res, want_res))}


def case_checkpoint(inp: dict, tmp: str) -> dict:
    """A state saved at 2x2, restored at 1x4: every leaf gathered whole."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.dist.sharding import Sharding, ShardingRules
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.models.params import trainable, tree_map
    from repro_torch.optim.adamw import OptConfig, opt_init, opt_state_specs

    cfg = reduced(ARCHS[inp["arch"]])
    model = build_model(cfg, device="cpu")
    opt = OptConfig(kind=inp["opt"])
    full = trainable(params_from_jax(inp["params"], device="cpu"))
    shardings = {}
    for shape in ((2, 2), (1, 4)):
        mesh = _mesh(shape)
        rules = ShardingRules.for_arch(cfg, mesh)
        p_sh = rules.sharding_tree(model.param_specs())
        o_sh = tree_map(lambda e, m=mesh: Sharding(m, e),
                        opt_state_specs(opt, model.param_specs(), rules.pspec))
        shardings[shape] = (p_sh, o_sh)
    p_sh, o_sh = shardings[(2, 2)]
    params = _local(full, p_sh)
    state = opt_init(opt, params, shardings=p_sh)
    state["m"] = tree_map(lambda t: t.float() * 3, params)      # moments that are not zeros
    path = save_checkpoint(os.path.join(tmp, "ckpt"), 5, (params, state), mesh_shape=(2, 2),
                           shardings=(p_sh, o_sh))
    p4, o4 = shardings[(1, 4)]
    like_p = _local(full, p4)
    like = (like_p, opt_init(opt, like_p, shardings=p4))
    (got_p, got_o), manifest = restore_checkpoint(path, like, shardings=(p4, o4))
    return {"path": path, "mesh_shape": manifest["mesh_shape"],
            "restored": _gathered(got_p, p4), "restored_state": _gathered(got_o, o4),
            "saved": _gathered(params, p_sh), "saved_state": _gathered(state, o_sh)}


CASES = (("launcher", case_launcher), ("train", case_train), ("ep_all", case_ep_all),
         ("ep_tp", case_ep_tp), ("ff_over_data", case_ff_over_data),
         ("experts_over_mesh", case_experts_over_mesh),
         ("serve", case_serve), ("compressed_psum", case_compressed_psum),
         ("checkpoint", case_checkpoint))
