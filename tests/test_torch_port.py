"""The port on its own, on the CPU: package isolation, entry points that
refuse to fall back to the CPU, dispatch, and the engine's invariants
(fused K equals K=1, the fixup leaves the prefill cache as it was).

This file imports no JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.core.registry import KernelImpl, KernelRegistry
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model, init_params
from repro_torch.serve.engine import ServeEngine, ServeTruncated

SRC = Path(__file__).resolve().parents[1] / "src"
CFG = reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128)


@pytest.fixture(scope="module")
def tiny():
    model = build_model(CFG, device="cpu")
    return model, init_params(model.param_specs(), 3, device="cpu")


def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.serve.engine, repro_torch.kernels.ops\n"
        "import repro_torch.serve.paged, repro_torch.core.policy\n"
        "import repro_torch.kernels.paged_decode_attention, repro_torch.kernels.ssd\n"
        "import repro_torch.models.ssm, repro_torch.configs.mamba2_780m\n"
        "import repro_torch.core, repro_torch.core.hsa, repro_torch.core.ledger\n"
        "import repro_torch.core.roles, repro_torch.core.reconfig\n"
        "import repro_torch.core.hsa.scheduler, repro_torch.core.hsa.runtime\n"
        "import repro_torch.kernels.conv2d, repro_torch.paper_roles\n"
        "import repro_torch.dist, repro_torch.dist.sharding, repro_torch.dist.act\n"
        "import repro_torch.dist.collectives, repro_torch.launch.mesh\n"
        "import repro_torch.launch.serve, repro_torch.launch.train\n"
        "import repro_torch.hw, repro_torch.roofline, repro_torch.roofline.analysis\n"
        "import repro_torch.roofline.extrapolate, repro_torch.roofline.report\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.specs\n"
        "import repro_torch.examples.quickstart, repro_torch.examples.multi_tenant\n"
        "import repro_torch.examples.reconfig_demo, repro_torch.examples.serve_lm\n"
        "import repro_torch.examples.train_lm\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_raise_without_a_card(tiny):
    """With no ``device=`` the entry points run on the card; where there is
    none they raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model, params = tiny
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(ARCHS["mamba2-780m"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(model.param_specs(), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "llama3.2-1b", "--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1, 1), ("data", "model"))


def test_decoder_refuses_the_families_not_ported():
    """Every family of the JAX package is ported: hybrid (attention and SSM
    heads in one layer) and windowed configs build as ``DecoderLM`` and
    audio ones as ``EncDecLM`` (the decoder refuses them).  What JAX
    refuses stays refused, with JAX's messages: chunked prefill and paged
    decode of hybrid or windowed layers."""
    import dataclasses

    from repro_torch.configs.base import SSMConfig
    from repro_torch.models import EncDecLM
    from repro_torch.models.model import DecoderLM

    hybrid = dataclasses.replace(CFG, name="hybrid-smoke", family="hybrid", parallel_ssm=True,
                                 attn_window=8, ssm=SSMConfig(state_dim=16, head_dim=16,
                                                              chunk=16))
    windowed = dataclasses.replace(CFG, attn_window=8)
    tokens = torch.tensor([[1, 2, 3, 4]])
    for cfg, kind in ((hybrid, "hybrid"), (windowed, "dense")):
        model = build_model(cfg, device="cpu")
        assert isinstance(model, DecoderLM) and model.kinds == [kind] * cfg.num_layers
        params = init_params(model.param_specs(), 0, device="cpu")
        _, cache = model.prefill(params, {"tokens": tokens}, cache_len=16)
        assert cache["k"].shape[3] == 8                  # the ring: min(cache_len, window)
        with pytest.raises(ValueError, match=f"chunked prefill supports plain dense GQA layers "
                                             f"only, not '{kind}' \\(mla=False, window=8\\)"):
            model.prefill_chunk(params, tokens, cache, start=0)
        with pytest.raises(ValueError, match=f"paged decode supports plain GQA KV caches only, "
                                             f"not '{kind}' \\(mla=False, window=8\\)"):
            model.decode_step(params, tokens[:, :1],
                              {**cache, "block_table": torch.zeros(1, 2, dtype=torch.int32)})
    audio = reduced(ARCHS["whisper-large-v3"], layers=2, d_model=64, vocab=128)
    assert isinstance(build_model(audio, device="cpu"), EncDecLM)
    with pytest.raises(ValueError, match="EncDecLM"):
        DecoderLM(audio, device="cpu")
    build_model(ARCHS["mamba2-780m"], device="cpu")


def test_policy_flags_and_resolution():
    assert dispatch.policy_from_flag("cuda") == ("cuda", "triton", "torch", "reference")
    assert dispatch.policy_from_flag("cuda-strict") == ("cuda", "triton")
    assert dispatch.current().prefer == ("torch", "reference")
    assert dispatch.current().device_kind == "cuda"
    with pytest.raises(ValueError):
        dispatch.policy_from_flag("pallas")
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        assert {dispatch.resolve(op).source for op in
                ("matmul", "rmsnorm", "flash_attention", "decode_attention",
                 "paged_decode_attention", "ssd")} == {"cuda"}
    with dispatch.use(prefer=("reference",)):
        assert dispatch.resolve("matmul").source == "reference"


def test_resolve_memo_sees_late_registration():
    reg = KernelRegistry()
    reg.register(KernelImpl(op="f", device_kind="any", source="torch", fn=lambda: "torch"))
    with dispatch.use(registry=reg, prefer=("cuda", "torch")):
        assert dispatch.op("f") == "torch"
        reg.register(KernelImpl(op="f", device_kind="cuda", source="cuda", fn=lambda: "cuda"))
        assert dispatch.op("f") == "cuda"
    with pytest.raises(ValueError):
        KernelImpl(op="f", device_kind="cuda", source="pallas", fn=lambda: None)


def _generate(model, params, *, fusion, max_new=7, slots=2,
              prompts=([3, 14, 15, 92], [7, 8], [1, 2, 3, 4, 5, 6], [42])):
    eng = ServeEngine(model, params, batch_slots=slots, max_len=32, decode_fusion=fusion,
                      device="cpu")
    for p in prompts:
        eng.submit(list(p), max_new_tokens=max_new)
    return [r.generated for r in sorted(eng.run_to_completion(), key=lambda r: r.uid)]


@pytest.mark.parametrize("max_new", [1, 2, 5, 7])
def test_fused_decode_equals_single_step(tiny, max_new):
    """K=4 and K=3 give the K=1 streams, also when the budget is not a
    multiple of K (the last launch's surplus steps are masked)."""
    model, params = tiny
    base = _generate(model, params, fusion=1, max_new=max_new)
    assert all(len(g) == max_new for g in base)
    assert _generate(model, params, fusion=4, max_new=max_new) == base
    assert _generate(model, params, fusion=3, max_new=max_new, slots=1) == base


def test_fixup_leaves_the_prefill_cache_verbatim(tiny):
    """The bucket-pad fixup decodes the last prompt token at its true
    position; its k/v write must not land in the cache the slot keeps."""
    model, params = tiny
    prompt = [5, 9, 2, 11, 7]                       # padded to the 8-row bucket
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, device="cpu")
    eng.submit(prompt, max_new_tokens=1)
    eng.step()
    _, want = model.prefill(params, {"tokens": torch.tensor([prompt + [0, 0, 0]])},
                            cache_len=32)
    assert eng.fixup_calls == 1 and eng.prefill_calls == 1
    # rows [0, n): row n-1 is where the fixup wrote; row n took the masked
    # decode step's dummy write
    for key in ("k", "v"):
        torch.testing.assert_close(eng._cache[key][:, 0, :, :5], want[key][:, 0, :, :5],
                                   atol=0, rtol=0)


def test_engine_refuses_what_the_slice_lacks(tiny):
    """Temperature sampling serves (it was refused before the sampler was
    ported); a fusion depth below 1, a seed outside uint32 and a request
    past ``max_len`` are refused."""
    model, params = tiny
    eng = ServeEngine(model, params, temperature=0.7, seed=3, device="cpu")
    eng.submit([5, 9, 2], max_new_tokens=4)
    (req,) = eng.run_to_completion()
    assert len(req.generated) == 4 and eng.sample_calls == 4
    with pytest.raises(ValueError):
        ServeEngine(model, params, decode_fusion=0, device="cpu")
    with pytest.raises(ValueError, match="seed"):
        ServeEngine(model, params, seed=-1, device="cpu")
    eng = ServeEngine(model, params, max_len=16, device="cpu")
    with pytest.raises(ValueError):
        eng.submit([1] * 10, max_new_tokens=7)


def test_run_to_completion_raises_on_truncation(tiny):
    model, params = tiny
    eng = ServeEngine(model, params, batch_slots=1, max_len=32, device="cpu")
    eng.submit([1, 2, 3], max_new_tokens=10)
    eng.submit([4, 5], max_new_tokens=10)
    with pytest.raises(ServeTruncated) as ei:
        eng.run_to_completion(max_steps=2)
    assert len(ei.value.done) == 0 and len(ei.value.pending) == 2
    assert len(ei.value.pending[0].generated) >= 1
    done = eng.run_to_completion()
    assert len(done) == 2 and all(len(r.generated) == 10 for r in done)
    assert all(r.arrival_t <= r.first_token_t <= r.finish_t for r in done)


def test_tied_unembed_leaves_the_tf32_flag_as_it_was(tiny):
    """The tied unembed runs its f32 product without TF32, and leaves the
    process-wide flag as the caller set it."""
    from repro_torch.models import layers

    model, params = tiny
    h = torch.ones(1, 1, CFG.d_model, dtype=torch.bfloat16)
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    try:
        for setting in (True, False):
            flags.allow_tf32 = setting
            logits = layers.unembed(params["embed"], h)
            assert flags.allow_tf32 is setting
            assert logits.dtype == torch.float32 and logits.shape == (1, 1, CFG.vocab_size)
    finally:
        flags.allow_tf32 = before


def test_bucket_len_is_the_next_power_of_two_capped():
    assert [ServeEngine.bucket_len(n, 1024) for n in (1, 5, 8, 9, 64, 300, 600, 1024)] == \
        [8, 8, 8, 16, 64, 512, 1024, 1024]
    assert ServeEngine.bucket_len(700, 512) == 512


def test_hsa_runtime_raises_without_a_card_unless_given_the_cpu():
    """``hsa_init()`` and ``Agent.discover()`` run on the card by default;
    without one they raise, and the CPU runs them only when asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core import hsa

    hsa.hsa_shut_down()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hsa.Agent.discover()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hsa.hsa_init()
    with pytest.raises(RuntimeError, match="hsa_init"):
        hsa.hsa_system()
    (agent,) = hsa.Agent.discover(device="cpu")
    assert agent.kind == "cpu" and agent.name == "cpu:0"
    assert agent.regions[0].kind == "global" and agent.regions[0].bandwidth_bps == 0.0
    sys_ = hsa.hsa_init(num_regions=2, device="cpu")
    try:
        assert hsa.hsa_system() is sys_ and sys_.default_agent is sys_.agents[0]
        assert sys_.queue_of(sys_.default_agent).name == "cpu:0/q0"
    finally:
        hsa.hsa_shut_down()
