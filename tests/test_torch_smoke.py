"""``chip_smoke.py``'s own checks, on the CPU.

The script holds each attention kernel to its plain version row by row
(relative L2 over the head dim) and reads a planted fault — one key tile
dropped, or for paged attention one page remapped — by the same measure,
and the ssd kernel per output row and per head's final state beside a
planted fault that zeroes the carried state at a chunk boundary, and the
paper-role kernels (conv2d, the f32 matmul) exactly or within 2e-4 beside
a planted fault (a filter tap or a K tile dropped); these
tests show, at a small size, that the plain versions pass those checks,
that the planted faults lie beyond their limits and fail them, that the
model phases run the engine's calls (and, for llama, chunked prefill), that
the serve phases' runs give the launch counts they check (with the kernels'
plain versions counted as launches), that the tenants phase serves through
the HSA queue beside the paper's four roles with every check it makes on
the card passing, and that the script refuses to run without a card.  This file imports no JAX.
"""

from __future__ import annotations

import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.core.registry import KernelImpl, KernelRegistry
from repro_torch.kernels import conv2d as conv_k
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import matmul as mm_k
from repro_torch.kernels import paged_decode_attention as paged_k
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rms_k
from repro_torch.kernels import ssd as ssd_k
from repro_torch.models import build_model, init_params

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen).to(torch.bfloat16)


def _flash_case(causal: bool):
    gen = torch.Generator().manual_seed(11)
    S = T = 256
    q, k, v = _randn(gen, 1, 8, S, 64), _randn(gen, 1, 2, T, 64), _randn(gen, 1, 2, T, 64)
    sound, dropped = cs.flash_masks(torch, S, T, causal, "cpu")
    fault = cs.masked_attention(torch, q, k, v, sound & ~dropped)
    want = fa_k.plain_flash_attention(q, k, v, causal=causal)
    return (cs.masked_attention(torch, q, k, v, sound), ref.flash_attention(q, k, v, causal=causal),
            want, fault, dropped.sum(dim=-1) == 64)


def _decode_case():
    gen = torch.Generator().manual_seed(12)
    T = 1024
    lengths = torch.tensor([1, 1024, 5, 600, 45], dtype=torch.int32)
    q, kc, vc = _randn(gen, 5, 8, 64), _randn(gen, 5, 2, T, 64), _randn(gen, 5, 2, T, 64)
    valid, dropped = cs.decode_masks(torch, lengths, T)
    fault = cs.masked_attention(torch, q[:, :, None], kc, vc, (valid & ~dropped)[:, None, None])
    fault = fault[:, :, 0]
    masked = cs.masked_attention(torch, q[:, :, None], kc, vc, valid[:, None, None, :])[:, :, 0]
    want = dec_k.plain_decode_attention(q, kc, vc, lengths)
    return (masked, ref.decode_attention(q, kc, vc, lengths), want, fault,
            dropped.any(dim=-1)[:, None])


def _paged_case():
    gen = torch.Generator().manual_seed(13)
    ps, NP = 16, 64
    lengths = torch.tensor([1, 1024, 5, 600, 37], dtype=torch.int32)
    P = 5 * NP + 1
    q, kp, vp = _randn(gen, 5, 8, 64), _randn(gen, P, 2, ps, 64), _randn(gen, P, 2, ps, 64)
    table = (torch.randperm(P - 1, generator=gen)[: 5 * NP] + 1).reshape(5, NP).to(torch.int32)
    faulted, touched = cs.remap_one_page(table, lengths, ps)
    kg, vg = ref.gather_kv_pages(kp, table), ref.gather_kv_pages(vp, table)
    valid = torch.arange(NP * ps)[None, :] < lengths[:, None]
    masked = cs.masked_attention(torch, q[:, :, None], kg, vg, valid[:, None, None, :])[:, :, 0]
    want = paged_k.plain_paged_decode_attention(q, kp, vp, table, lengths)
    fault = paged_k.plain_paged_decode_attention(q, kp, vp, faulted, lengths)
    return (masked, ref.paged_decode_attention(q, kp, vp, table, lengths), want, fault,
            touched[:, None])


CASES = {"flash_causal": lambda: _flash_case(True), "flash_full": lambda: _flash_case(False),
         "decode": _decode_case, "paged": _paged_case}


def test_remap_one_page_moves_the_last_whole_page_in_length():
    table = torch.arange(1, 13, dtype=torch.int32).reshape(3, 4)
    faulted, touched = cs.remap_one_page(table, torch.tensor([5, 16, 63]), 16)
    assert touched.tolist() == [False, True, True]
    assert (faulted != table).sum() == 2
    assert faulted[1, 0] == table[2, 0] and faulted[2, 2] == table[0, 0]
    one, _ = cs.remap_one_page(table[:1], torch.tensor([40]), 16)
    assert one[0].tolist() == [1, 0, 3, 4]


def test_fault_masks_drop_one_whole_tile():
    sound, dropped = cs.flash_masks(torch, 128, 256, True, "cpu")
    assert sound[0].sum() == 129 and dropped.sum(dim=-1).max() == 64
    assert not dropped[:, :64].any() and not dropped[:, 128:].any()
    valid, dropped = cs.decode_masks(torch, torch.tensor([5, 32, 45, 600, 1024]), 1024)
    assert dropped.sum(dim=-1).tolist() == [0, 0, 32, 32, 32]
    first = dropped.float().argmax(dim=-1).tolist()
    assert first[2:] == [0, 544, 992] and not (dropped & ~valid).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_masked_attention_is_the_plain_version(case):
    masked, _, want, _, _ = CASES[case]()
    assert float(cs.row_rel_l2(torch, masked, want).max()) <= 1e-3


@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_check_passes_sound_output_and_sees_a_dropped_tile(case):
    _, oracle, want, fault, touched = CASES[case]()
    res = cs.attention_err(torch, oracle, want, fault, touched)
    assert res["max_rel_l2"] <= cs.ATTN_REL_L2_TOL
    assert res["planted_fault_min_rel_l2"] > 5 * cs.ATTN_REL_L2_TOL
    with pytest.raises(AssertionError, match="disagrees"):
        cs.attention_err(torch, fault, want, fault, touched)


def test_attention_check_refuses_a_blind_fault():
    """A planted fault the limit cannot see fails the check itself."""
    _, oracle, want, _, touched = _flash_case(True)
    with pytest.raises(AssertionError, match="cannot see it"):
        cs.attention_err(torch, oracle, want, want, touched)


def test_model_phase_runs_the_engine_calls_on_a_small_model():
    cfg = reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128)
    model = build_model(cfg, device="cpu")
    res = cs.model_phase(torch, model, init_params(model.param_specs(), 0, device="cpu"), 0)
    assert res["buckets"] == [8, 64, 512, 1024]
    assert [len(res[k]["rel_l2"]) for k in ("prefill", "fixup", "decode", "chunked")] == \
        [4, 3, 4, 3]
    assert res["chunked"]["prompt_lengths"] == [64, 300, 600]
    assert res["chunked"]["paged_equal_staging_bitwise"]
    assert max(max(res[k]["rel_l2"]) for k in ("prefill", "fixup", "decode", "chunked")) < 0.05


def _counting_registry(*, with_others: bool = False) -> KernelRegistry:
    """A registry whose cuda source for each op is the kernel's plain
    version counted as a launch of its module, as the wrapper counts one (a
    matmul TMA cannot take counted as the edge kernel's); ``with_others``
    keeps the global registry's torch and reference sources beside them."""
    from repro_torch.core.registry import GLOBAL_REGISTRY

    reg = KernelRegistry()
    if with_others:
        reg.restore({key: [i for i in impls if i.source != "cuda"]
                     for key, impls in GLOBAL_REGISTRY.snapshot().items()})
    for mod, op, plain in ((mm_k, "matmul", mm_k.plain_matmul),
                           (rms_k, "rmsnorm", rms_k.plain_rmsnorm),
                           (fa_k, "flash_attention", fa_k.plain_flash_attention),
                           (dec_k, "decode_attention", dec_k.plain_decode_attention),
                           (paged_k, "paged_decode_attention",
                            paged_k.plain_paged_decode_attention),
                           (ssd_k, "ssd", ssd_k.plain_ssd)):
        def counted(*args, _mod=mod, _plain=plain, **kwargs):
            if _mod is mm_k and not mm_k.tma_ready(*args[:2]):
                mm_k.edge_launches += 1
            else:
                _mod.launches += 1
            if _mod is ssd_k:
                kwargs.pop("chunk")               # the wrapper's keyword, not the plain's
            return _plain(*args, **kwargs)

        reg.register(KernelImpl(op=op, device_kind="cuda", source="cuda", fn=counted))
    return reg


def test_serve_phase_runs_three_engines_with_their_launch_counts():
    """The serve phase on a small model: dense, paged and paged + chunked
    runs complete, paged streams equal dense ones, the chunked run holds
    more than 8 requests at once, and every run's launches match its model
    calls — so on the card a miscount is the kernels', not the script's."""
    cfg = reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128)
    model = build_model(cfg, device="cpu")
    params = init_params(model.param_specs(), 0, device="cpu")
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k)
    with dispatch.use(registry=_counting_registry()):
        res = cs.serve_phase(torch, model, params, kernels, 0)
    runs = res["runs"]
    assert list(runs) == ["dense", "paged", "paged_chunked"]
    assert runs["dense"]["launches"]["paged_decode_attention"] == 0
    assert runs["paged"]["launches"]["decode_attention"] == 2 * runs["paged"]["fixup_calls"]
    chunked = runs["paged_chunked"]
    assert chunked["prefill_calls"] == 0 and chunked["chunk_calls"] > 16
    assert chunked["launches"]["flash_attention"] == 2 * chunked["chunk_calls"]
    assert chunked["peak_concurrency"] == 16 and runs["dense"]["peak_concurrency"] == 8
    # twice the slots in the dense run's KV memory: the pool alone, no staging
    assert chunked["kv_bytes"] == runs["paged"]["kv_bytes"] < runs["dense"]["kv_bytes"] * 1.01
    assert res["launches"]["matmul"] == sum(r["launches"]["matmul"] for r in runs.values())
    assert res["launches"]["ssd"] == 0


def test_granite_phase_runs_the_head_dim_128_calls_on_a_small_model():
    """The granite phase on a small granite-shaped model (head_dim 128, 4
    query heads a kv head, an untied unembed over an odd vocabulary): the
    calls run, the paged decode and paged chunks equal the dense and staging
    ones bit for bit, the logits agree with the torch source, and the launch
    counts it checks hold (plain versions counted as launches; the unembed
    as the edge kernel's)."""
    import dataclasses

    cfg = dataclasses.replace(reduced(ARCHS["granite-3-8b"], layers=2, d_model=64, vocab=131),
                              head_dim=128)
    model = build_model(cfg, device="cpu")
    params = init_params(model.param_specs(), 0, device="cpu")
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k)
    with dispatch.use(registry=_counting_registry(with_others=True)):
        res = cs.granite_phase(torch, model, params, kernels, 0)
    assert res["buckets"] == [8, 64, 256, 512, 512, 512, 512, 512]
    assert res["launches"] == {"matmul": 364, "rmsnorm": 130, "flash_attention": 32,
                               "decode_attention": 18, "paged_decode_attention": 2, "ssd": 0,
                               "matmul_edge": 26}
    assert res["paged_equal_dense_bitwise"]
    kinds = ("prefill", "fixup", "decode", "decode_paged", "chunk", "chunk_paged")
    assert [len(res[k]["rel_l2"]) for k in kinds] == [8, 8, 8, 8, 1, 1]
    assert max(max(res[k]["rel_l2"]) for k in kinds) < 0.05


def test_flash_split_rule_fills_the_card_only_where_tiles_are_few():
    """The split-KV rule: no split where the (q tile, head) blocks fill the
    132 SMs or walk few keys; where they do not, one split for every 384
    keys the longest walk sees, up to one block an SM and four splits."""
    assert fa_k.split_kv(1, 32, 512, 512) == 1                    # 256 blocks
    assert fa_k.split_kv(1, 32, 128, 1024) == 2                   # 64 blocks: two an SM
    assert fa_k.split_kv(1, 32, 128, 768) == 2
    assert fa_k.split_kv(1, 32, 128, 640) == 1                    # 640 keys
    assert fa_k.split_kv(1, 32, 8, 8) == 1
    assert fa_k.split_kv(1, 32, 64, 2048) == 4                    # 32 blocks
    assert fa_k.split_kv(1, 32, 64, 1024, head_dim=128) == 2
    assert fa_k.split_kv(1, 8, 100, 1200, False, 400) == 1        # the window leaves 640 keys
    assert fa_k.split_kv(1, 8, 100, 1200) == 3


SSM_CFG = reduced(ARCHS["mamba2-780m"], layers=2, d_model=64, vocab=128)


def _ssd_case(S: int):
    """The kernel phase's ssd check at a serving shape, with the plain
    version standing for the kernel; the sequential oracle beside it."""
    gen = torch.Generator().manual_seed(S)
    args = cs.ssd_inputs(torch, S, gen, "cpu")
    want = ssd_k.plain_ssd(*args, return_state=True)
    oracle = ref.ssd(*args, return_state=True)
    return oracle, want, cs.ssd_fault(torch, ssd_k.plain_ssd, *args, ssd_k.CHUNK)


def test_ssd_inputs_are_views_of_one_conv_output():
    x, a, b, c, dt = cs.ssd_inputs(torch, 20, torch.Generator().manual_seed(0), "cpu")
    assert x.shape == (1, 20, 48, 64) and b.shape == c.shape == (1, 20, 1, 128)
    assert x.data_ptr() == b.data_ptr() - 2 * 48 * 64 == c.data_ptr() - 2 * (48 * 64 + 128)
    assert x.stride(1) == b.stride(1) == 48 * 64 + 256 and not x.is_contiguous()
    assert bool(((a > -16) & (a < -1)).all()) and bool(((dt >= 1e-3) & (dt <= 1e-1)).all())
    assert cs.ssd_work(512)[0] == 8_224_960       # about 8 MB at S = 512


@pytest.mark.parametrize("S", [5, 256, 600])
def test_ssd_check_passes_the_oracle_and_sees_a_zeroed_state(S):
    oracle, want, fault = _ssd_case(S)
    res = cs.ssd_err(torch, oracle, want, fault)
    # bf16 roundings of y flipped by another summation order: a few 1e-3 at most
    assert res["max_rel_l2"] <= cs.SSD_Y_REL_L2_TOL / 4 and res["state_max_rel_l2"] <= 1e-4
    if S <= ssd_k.CHUNK:
        assert fault is None and res["planted_fault_min_rel_l2"] is None
        return
    assert res["planted_fault_min_rel_l2"] > 5 * cs.SSD_Y_REL_L2_TOL
    assert res["planted_fault_state_rel_l2"] > 5 * cs.SSD_STATE_REL_L2_TOL
    with pytest.raises(AssertionError, match="disagrees"):
        cs.ssd_err(torch, fault[:2], want, fault)


def test_ssd_check_refuses_a_blind_fault():
    oracle, want, _ = _ssd_case(256)
    with pytest.raises(AssertionError, match="cannot see it"):
        cs.ssd_err(torch, oracle, want, (*want, 240))


def test_ssm_model_phase_runs_the_engine_calls_on_a_small_model():
    model = build_model(SSM_CFG, device="cpu")
    res = cs.ssm_model_phase(torch, model, init_params(model.param_specs(), 0, device="cpu"), 0)
    assert res["prompt_lengths"] == [5, 37, 600]
    for run in ("full_depth", "full_depth_control_torch_vs_reference", "gated_depth_end_to_end"):
        assert [len(res[run][k]["rel_l2"]) for k in ("prefill", "decode")] == [3, 9]
        assert res[run]["state_decode"]["shape"] == [2, 3, 8, 16, 16]
        assert max(max(res[run][k]["rel_l2"]) for k in ("prefill", "decode")) < 0.05
    assert all(len(v["by_layer"]) == 2 for v in res["layers"].values())
    assert max(v["max"] for v in res["layers"].values()) < cs.SSM_LAYER_REL_L2_TOL


def test_ssm_serve_phase_counts_48_ssd_a_prefill_scaled_down():
    """The ssm run on a small model: 16 unbucketed prefills, no fixups, and
    every kernel's launches equal to what the model calls imply (2 layers:
    2 ssd a prefill, 4 matmuls and 5 norms a call, no attention)."""
    model = build_model(SSM_CFG, device="cpu")
    params = init_params(model.param_specs(), 0, device="cpu")
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k)
    with dispatch.use(registry=_counting_registry()):
        res = cs.ssm_serve_phase(torch, model, params, kernels, 0)
    run = res["runs"]["ssm"]
    calls = run["prefill_calls"] + run["decode_calls"]
    assert run["prefill_calls"] == 16 and run["fixup_calls"] == 0 and run["chunk_calls"] == 0
    assert run["launches"] == {"matmul": 4 * calls, "rmsnorm": 5 * calls, "flash_attention": 0,
                               "decode_attention": 0, "paged_decode_attention": 0, "ssd": 32}
    # 8 slots of 2 layers' [8, 16, 16] f32 state and [3, 160] bf16 conv tail
    assert run["state_bytes"] == 8 * 2 * (8 * 16 * 16 * 4 + 3 * 160 * 2)
    assert run["peak_concurrency"] == 8


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card here: the script exits non-zero and prints no result, from the
    checkout and from a directory that holds the script and nothing else."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=120, cwd=script.parent)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


# ---------------------------------------------------------------------------
# the paper-role kernels' checks and the tenants phase
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
def test_role_check_passes_plain_conv_and_sees_a_dropped_tap(dtype):
    gen = torch.Generator().manual_seed(21)
    if dtype == torch.int16:
        x = torch.randint(-100, 100, (1, 64, 64, 1), generator=gen).to(dtype)
        w = torch.randint(-8, 8, (5, 5, 1, 1), generator=gen).to(dtype)
    else:
        x, w = torch.randn((1, 32, 32, 1), generator=gen), torch.randn((3, 3, 1, 1), generator=gen)
    faulted = w.clone()
    faulted[tuple(int(i) for i in (w != 0).nonzero()[0])] = 0
    want, fault = conv_k.plain_conv2d(x, w), conv_k.plain_conv2d(x, faulted)
    check = cs.role_err(torch, ref.conv2d(x, w), want, fault, cs.TOL_ROLE_F32)
    assert check["planted_fault_min_max_abs_err"] > 0
    with pytest.raises(AssertionError, match="differs|disagrees"):
        cs.role_err(torch, fault, want, fault, cs.TOL_ROLE_F32)
    with pytest.raises(AssertionError, match="cannot see"):
        cs.role_err(torch, want, want, want.clone(), cs.TOL_ROLE_F32)


def test_role_check_sees_a_dropped_k_tile_in_the_f32_matmul():
    gen = torch.Generator().manual_seed(22)
    x, w = torch.randn((256, 256), generator=gen), torch.randn((256, 256), generator=gen)
    xf = x.clone()
    xf[:, 16:32] = 0
    want = mm_k.plain_matmul(x, w)
    check = cs.role_err(torch, mm_k.matmul(x, w), want, mm_k.plain_matmul(xf, w),
                        cs.TOL_ROLE_F32)
    assert check["max_abs_err"] <= 1e-3 and check["planted_fault_min_max_abs_err"] > 1
    assert cs.conv_work(1, 64, 64, 1, 5, 5, 1, 2) == ((64 * 64 + 25) * 2 + 60 * 60 * 4,
                                                      2 * 60 * 60 * 25)


@pytest.mark.parametrize("K", [2048, 1536, 136])
def test_matmul_check_sees_the_last_k_tile_dropped(K):
    gen = torch.Generator().manual_seed(23)
    x, w = _randn(gen, 8, K), (torch.randn(K, 512, generator=gen) * K ** -0.5).to(torch.bfloat16)
    xf = cs.drop_last_k_tile(x)
    last = (K - 1) // 64 * 64
    assert torch.equal(xf[:, :last], x[:, :last]) and not xf[:, last:].any()
    want = mm_k.plain_matmul(x, w)
    fault = mm_k.plain_matmul(xf, w)
    check = cs.matmul_err(torch, mm_k.matmul(x, w), want, fault, cs.TOL_BF16)
    assert check["max_abs_err"] == 0 and check["planted_fault_min_max_abs_err"] > 0.1
    with pytest.raises(AssertionError, match="disagrees"):
        cs.matmul_err(torch, fault, want, fault, cs.TOL_BF16)
    with pytest.raises(AssertionError, match="cannot see"):
        cs.matmul_err(torch, want, want, want.clone(), cs.TOL_BF16)


def test_sass_count_reads_each_bf16_kernel_and_refuses_one_without_wgmma(monkeypatch):
    sass = """
        Function : _ZN41_GLOBAL__N__1_matmul_cu_2_14mm_tile_kernelILi128ELi256EEEv14CUtensorMap_st
        /*0100*/ UTMALDG.2D [UR8], [UR4] ;
        /*0200*/ HGMMA.64x256x16.F32.BF16 R24, gdesc[UR8], RZ ;
        /*0210*/ HGMMA.64x256x16.F32.BF16 R24, gdesc[UR12], R24 ;
        Function : _ZN41_GLOBAL__N__1_matmul_cu_2_16mm_stream_kernelILi8EEEv14CUtensorMap_st
        /*0100*/ UTMALDG.2D [UR8], [UR4] ;
        /*0200*/ HGMMA.64x8x16.F32.BF16 R24, gdesc[UR8], RZ ;
        Function : _ZN41_GLOBAL__N__1_matmul_cu_2_13mm_f32_kernelEPKfS1_PfS2_iiiii
        /*0100*/ FFMA R1, R2, R3, R1 ;
"""

    class Native:
        def build_all(self):
            return {"matmul": Path("libmatmul.so")}

        def _nvcc(self):
            return "/cuda/bin/nvcc"

    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=sass, stderr="")

    monkeypatch.setattr(cs.subprocess, "run", run)
    counts = cs.bf16_matmul_sass(Native())
    assert calls[0][:2] == ["/cuda/bin/cuobjdump", "--dump-sass"]
    assert counts == {"mm_tile_kernel<128,256>": {"HGMMA": 2, "UTMALDG": 1},
                      "mm_stream_kernel<8>": {"HGMMA": 1, "UTMALDG": 1}}
    sass = sass.replace("HGMMA.64x8x16", "HMMA.16816")
    with pytest.raises(AssertionError, match="without wgmma"):
        cs.bf16_matmul_sass(Native())


def test_tenants_phase_shares_the_queue_with_the_paper_roles(monkeypatch):
    """The tenants phase on a small model on the CPU: the engine's streams
    through the tf-serving queue equal a direct run's, the opencl tenant's
    role packets equal their plain versions, the planner runs on measured
    costs, and the launch counts it checks hold (plain versions counted as
    launches: through the engine's registry for its kernels, through the
    wrappers for the paper roles)."""
    from repro_torch.core.registry import GLOBAL_REGISTRY

    cfg = reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128)
    model = build_model(cfg, device="cpu")
    params = init_params(model.param_specs(), 0, device="cpu")
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k)
    plain_conv = conv_k.conv2d

    def counted_conv(x, w):
        conv_k.launches += 1
        return plain_conv(x, w)

    def counted_f32(x, w, **kw):
        mm_k.f32_launches += 1
        return mm_k.plain_matmul(x, w, **kw)

    def counted_fixed(self, x):
        mm_k.fixed_launches += 1
        return counted_f32(x, self.weight, out_dtype=self.out_dtype, activation=self.activation)

    monkeypatch.setattr(conv_k, "conv2d", counted_conv)
    monkeypatch.setattr(mm_k.FixedWeightMatmul, "__call__", counted_fixed)
    snap = GLOBAL_REGISTRY.snapshot()
    GLOBAL_REGISTRY.register(KernelImpl(op="matmul", device_kind="cuda", source="cuda",
                                        fn=counted_f32), allow_override=True)
    try:
        with dispatch.use(registry=_counting_registry()):
            _, prompts = cs.serve_prompts(torch, cfg.vocab_size, 0)
            direct, streams = cs.serve_run(torch, model, params, kernels, prompts[:6],
                                           batch_slots=8)
            monkeypatch.setattr(cs, "serve_prompts", lambda *a: (None, prompts[:6]))
            res = cs.tenants_phase(torch, model, params, kernels, 0, streams)
    finally:
        GLOBAL_REGISTRY.restore(snap)
    assert set(res["plans_budget_4"]) == {3, 8, 16}
    assert res["opencl_packets"]["conv"] >= 6 and res["opencl_packets"]["fixed_fc"] >= 1
    assert res["launches"]["conv2d"] >= res["opencl_packets"]["conv"]
    assert res["queues"]["tf-serving"]["dispatched"] == (
        res["run"]["prefill_calls"] + res["run"]["fixup_calls"] + res["run"]["decode_calls"])
    assert res["residency"]["misses"] > 0 and res["opencl_exec_between_tf_packets"] > 0
    assert res["run"]["launches"] == res["routed_alone"]["launches"] == direct["launches"] \
        == res["direct_before"]["launches"] == res["direct_after"]["launches"]
    assert len(res["routed_vs_direct"]["decode_tokens_per_s"]) == 4
    assert set(res["ledger_by_queue"]) >= {"tf-serving", "opencl"}
