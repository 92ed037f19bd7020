"""``chip_smoke.py``'s train phase and its checks, on the CPU.

The phase at a small size (a 4-layer llama3.2-1b of d_model 64, 4 x 64
tokens a step, remat ``full``): every check it makes on the card passes
(the first step against f32, the loss falling with no kernel launched,
greedy streams and scores under cuda-strict equal the torch source's, a
stale ``tok_f32`` caught, resume bitwise); and the stream check itself
stops at a near tie, sees a token that parts where the scores lie apart
and measures the scores.  This file imports no JAX.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

import repro_torch.configs as configs_pkg
import repro_torch.data.pipeline as pipeline
import repro_torch.models as models_pkg
import repro_torch.train.step as step_mod
from repro_torch.configs import ARCHS, reduced

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _on_the_cpu(monkeypatch, tmp_path):
    """The phase's entry points on the CPU at a small size; the card's
    memory counters as no-ops; the resume checkpoint under ``tmp_path``."""
    small = dataclasses.replace(reduced(ARCHS["llama3.2-1b"], layers=4, d_model=64, vocab=256),
                                remat="full")
    build, init = models_pkg.build_model, models_pkg.init_params
    batches = pipeline.make_batch_iterator
    monkeypatch.setattr(configs_pkg, "get_arch", lambda name: small)
    monkeypatch.setattr(models_pkg, "build_model",
                        lambda cfg, device="cpu": build(cfg, device="cpu"))
    cpu_init = lambda specs, seed=0, device="cpu": init(specs, seed, device="cpu")  # noqa: E731
    monkeypatch.setattr(models_pkg, "init_params", cpu_init)
    monkeypatch.setattr(step_mod, "init_params", cpu_init)
    monkeypatch.setattr(pipeline, "make_batch_iterator",
                        lambda cfg, **kw: batches(cfg, **{**kw, "device": "cpu"}))
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "TRAIN_BATCH", 4)
    monkeypatch.setattr(cs, "TRAIN_SEQ", 64)
    monkeypatch.setattr(cs, "ROOT", tmp_path)
    # the trace's marker kernels need a card: the traced call runs untraced
    monkeypatch.setattr(cs, "traced_call",
                        lambda torch, call, steps=1: {"calls": steps, "ran": call() is not None})
    return small


def test_train_phase_passes_its_checks_on_a_small_model(monkeypatch, tmp_path):
    small = _on_the_cpu(monkeypatch, tmp_path)
    res = cs.train_phase(torch, 0, "cpu", "no card")
    first, train = res["first_step"], res["train"]
    assert first["leaves"] == 2 + 9 * small.num_layers
    assert max(first["loss_rel"], first["grad_norm_rel"]) <= cs.TRAIN_F32_REL_TOL
    assert train["steps"] == cs.TRAIN_STEPS and len(train["loss"]) == 1 + cs.TRAIN_STEPS
    assert train["loss"][-1] < train["loss"][0]
    assert not any(train["kernel_launches"].values())
    assert train["lr"][0] == pytest.approx(res["optimizer"]["lr"] / cs.TRAIN_WARMUP_STEPS)
    greedy = res["greedy"]
    assert not greedy["refreshed"]["differ_at"]
    assert greedy["refreshed"]["max_scores_rel_l2"] <= cs.MODEL_REL_L2_TOL
    stale = greedy["stale"]
    assert stale["differ_at"] or stale["max_scores_rel_l2"] > cs.MODEL_REL_L2_TOL
    assert set(greedy["kernels_held_against_plain"]) == {"matmul", "rmsnorm", "flash_attention",
                                                         "decode_attention"}
    assert train["trace"] == {"calls": 1, "ran": True}
    resume = res["resume"]
    assert resume["resumed_from"] == cs.RESUME_STEPS and not resume["leaves_differing"]
    assert not (tmp_path / "build" / "train_resume").exists()


def test_stream_check_stops_at_a_near_tie_and_sees_a_clear_difference():
    V = 5
    scores = torch.zeros(2, 3, V)
    scores[:, :, 2] = 10.0                      # token 2, clearly ahead
    scores[1, 1, 3] = torch.nextafter(torch.tensor(10.0), torch.tensor(0.0))  # a near tie
    want = torch.full((2, 3), 2)
    res = cs.streams_agree(torch, want.clone(), scores.clone(), want, scores)
    # the second stream stops at its near tie: 3 + 1 tokens compared
    assert res == {"compared": 4, "of": 6, "differ_at": [], "max_scores_rel_l2": 0.0}
    got = want.clone()
    got[0, 1] = 4
    assert cs.streams_agree(torch, got, scores, want, scores)["differ_at"] == [[0, 1]]
    got = want.clone()
    got[1, 2] = 4                               # past the near tie: not compared
    assert cs.streams_agree(torch, got, scores, want, scores)["differ_at"] == []
    off = scores.clone()
    off[0, 0, 0] = 5.0
    assert cs.streams_agree(torch, want, off, want, scores)["max_scores_rel_l2"] == \
        pytest.approx(0.5)


def test_train_flops_count_six_n_and_the_causal_half_of_attention():
    cfg = ARCHS["llama3.2-1b"]
    n = 1_235_814_400
    attention = 3 * 16 * 2 * 8 * 32 * 1024 * 1024 * 64
    assert cs.train_flops(cfg, n, 8, 1024) == 6 * n * 8 * 1024 + attention


def test_dist_phase_passes_its_checks_on_a_small_model():
    """Phase 17 on the CPU over gloo at a small size: the sharded steps on a
    1x1 mesh equal the model's calls bit for bit, two train steps under the
    rules equal the one-device step's leaves bit for bit, the serving
    launcher answers every request, compressed_psum's checks pass; the
    process group is gone after."""
    import torch.distributed as dist

    from repro_torch.kernels import modules

    small = reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=256)
    res = cs.dist_phase(torch, modules(), 0, "cpu", "no card", cfg=small, device="cpu",
                        train_batch=(4, 64), check_launches=False,
                        serve_argv=(*cs.DIST_SERVE_ARGV, "--reduced", "--max-new", "4"))
    assert res["backend"] == "gloo" and not dist.is_initialized()
    assert res["serve_steps"]["logits_differ_at"] == [] and res["serve_steps"]["tokens_equal"]
    assert res["serve_launcher"]["last_line"] == "[serve] completed 6/6 requests"
    train = res["train_steps"]
    assert train["leaves_differing"] == {} and train["leaves"] == 2 + 9 * small.num_layers
    assert train["loss"]["sharded"] == train["loss"]["one_device"]
    cp = res["compressed_psum"]
    assert cp["quantize_bitwise_cpu"] and cp["mean_is_payload"] and cp["residual_exact"]
    assert set(res["launches"]) == set(cs.DIST_KERNELS)
