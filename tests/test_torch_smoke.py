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
from repro_torch.kernels import sample as sample_k
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
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k, sample_k)
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
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k, sample_k)
    with dispatch.use(registry=_counting_registry(with_others=True)):
        res = cs.granite_phase(torch, model, params, kernels, 0)
    assert res["buckets"] == [8, 64, 256, 512, 512, 512, 512, 512]
    assert res["launches"] == {"matmul": 364, "rmsnorm": 130, "flash_attention": 32,
                               "decode_attention": 18, "paged_decode_attention": 2, "ssd": 0,
                               "sample": 0, "matmul_edge": 26}
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
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k, sample_k)
    with dispatch.use(registry=_counting_registry()):
        res = cs.ssm_serve_phase(torch, model, params, kernels, 0)
    run = res["runs"]["ssm"]
    calls = run["prefill_calls"] + run["decode_calls"]
    assert run["prefill_calls"] == 16 and run["fixup_calls"] == 0 and run["chunk_calls"] == 0
    assert run["launches"] == {"matmul": 4 * calls, "rmsnorm": 5 * calls, "flash_attention": 0,
                               "decode_attention": 0, "paged_decode_attention": 0, "ssd": 32,
                               "sample": 0}
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
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k, sample_k)
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


def test_row_invariance_check_reads_launch_size_and_position():
    """The rmsnorm row-invariance check: a row-wise function passes; one
    whose rows depend on the launch's row count, or on where a row sits,
    fails."""
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(600, 64, generator=g), torch.randn(64, generator=g)
    perm = torch.randperm(600, generator=g)
    res = cs.row_invariance(torch, lambda a, b: (a * b).cumsum(-1), x, w, perm)
    assert res == {"D": 64, "rows": 600, "launch_rows": [1, 3, 8, 128], "permuted": True}
    with pytest.raises(AssertionError, match="1-row launch"):
        cs.row_invariance(torch, lambda a, b: a * b + a.shape[0] * 1e-3, x, w, perm)
    at_row = lambda a, b: a * b + torch.arange(a.shape[0])[:, None] * 1e-3  # noqa: E731
    with pytest.raises(AssertionError, match="permutation"):
        cs.row_invariance(torch, at_row, x, w, perm)


def test_instance_check_refuses_a_built_matmul_instance_no_row_ran():
    """Every matmul instance ``cuobjdump`` lists, and the mma.sync edge
    kernel, must have run in some kernel-phase row."""
    sass = {"matmul": {"mm_stream_kernel<8>": {}},
            "matmul_edge": {"mm_edge_stream_kernel<8,0>": {}},
            "matmul_f32": {"mm_f32_kernel<0,64,64>": {}}}
    rows = [{"name": "matmul", "instance": "mm_stream_kernel<8>"},
            {"name": "matmul_edge", "instance": "mm_edge_stream_kernel<8,0>"},
            {"name": "matmul_edge", "instance": "mm_edge_kernel"},
            {"name": "matmul_f32", "instance": "mm_f32_kernel<0,64,64>"},
            {"name": "rmsnorm"}]
    assert cs.check_instances(rows, sass) == {"mm_stream_kernel<8>", "mm_edge_stream_kernel<8,0>",
                                              "mm_edge_kernel", "mm_f32_kernel<0,64,64>"}
    for drop in range(4):
        with pytest.raises(AssertionError, match="never held against"):
            cs.check_instances(rows[:drop] + rows[drop + 1:], sass)


def test_instance_check_refuses_a_built_decode_or_ssd_instance_no_row_ran():
    """The decode attention instances and the ssd kernel that ``cuobjdump``
    lists are held the same way as the matmul's."""
    sass = {"matmul": {}, "matmul_edge": {}, "matmul_f32": {},
            "decode_attention": {"dec_kernel<64,DenseRows>": {}, "dec_kernel<64,PagedRows>": {}},
            "ssd": {"ssd_kernel": {}}}
    rows = [{"name": "matmul_edge", "instance": "mm_edge_kernel"},
            {"name": "decode_attention", "instance": "dec_kernel<64,DenseRows>"},
            {"name": "paged_decode_attention", "instance": "dec_kernel<64,PagedRows>"},
            {"name": "ssd", "instance": "ssd_kernel"}]
    cs.check_instances(rows, sass)
    for drop in range(1, 4):
        with pytest.raises(AssertionError, match="never held against"):
            cs.check_instances(rows[:drop] + rows[drop + 1:], sass)


def test_sass_names_each_decode_instance_and_the_ssd_kernel(monkeypatch):
    """``cuobjdump``'s mangled names of the decode kernel's dense and paged
    instances and of the ssd kernel, and the mma.sync each must hold."""
    sass = """
        Function : _ZN52_GLOBAL__N__676c91e2_19_decode_attention_cu_34d849a810dec_kernelILi128ENS_9DenseRowsEEEvPK13__nv_bfloat16S4_S4_T0_PKiPS2_Pf
        /*0100*/ HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        Function : _ZN52_GLOBAL__N__676c91e2_19_decode_attention_cu_34d849a810dec_kernelILi16ENS_9PagedRowsEEEvPK13__nv_bfloat16S4_S4_T0_PKiPS2_Pf
        /*0100*/ HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0110*/ HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        Function : _ZN38_GLOBAL__N__00549f64_6_ssd_cu_9aa38bd610ssd_kernelEPK13__nv_bfloat16PKfS2_S2_S4_PS0_Pf
        /*0100*/ HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""

    class Native:
        def build_all(self):
            return {"decode_attention": Path("libdec.so"), "ssd": Path("libssd.so")}

        def _nvcc(self):
            return "/cuda/bin/nvcc"

    monkeypatch.setattr(cs.subprocess, "run",
                        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 0, stdout=sass))
    assert cs.decode_sass(Native()) == {
        "dec_kernel<128,DenseRows>": {"HGMMA": 0, "UTMALDG": 0, "HMMA": 1},
        "dec_kernel<16,PagedRows>": {"HGMMA": 0, "UTMALDG": 0, "HMMA": 2}}
    assert cs.ssd_sass(Native()) == {"ssd_kernel": {"HGMMA": 0, "UTMALDG": 0, "HMMA": 1}}
    sass = sass.replace("HMMA", "FFMA")
    with pytest.raises(AssertionError, match="without mma.sync"):
        cs.ssd_sass(Native())


def test_decode_split_check_needs_every_served_split_count():
    """The split counts the rule picks at the served shapes (decode steps
    over 1024, 512 and 256 rows, every fixup) must each run in some row of
    the kernel."""
    lengths, _ = cs.serve_prompts(torch, 128, 0)
    served = cs.served_decode_splits(dec_k, lengths)
    assert served == {"decode_attention": {1, 2, 3, 4}, "paged_decode_attention": {2, 4}}
    rows = ([{"name": "decode_attention", "splits": n} for n in (1, 2, 3, 4)]
            + [{"name": "paged_decode_attention", "splits": n} for n in (2, 4)])
    assert cs.check_splits(rows, served) == {"decode_attention": [1, 2, 3, 4],
                                             "paged_decode_attention": [2, 4]}
    with pytest.raises(AssertionError, match="no row ran"):
        cs.check_splits(rows[1:], served)


def test_ssd_kernel_work_counts_the_bf16_passes():
    """The kernel's own tensor-core flops: one C·Bᵀ pass and two for each
    product with an f32 operand, over the 16-row tiles it runs: the causal
    tile pairs of a chunk's live tiles, C·hᵀ only after the first chunk."""
    N, P = 128, 64
    pair = 2 * 16 * 16 * (N + 2 * P)          # C·Bᵀ and M'x on one tile pair
    rows = 2 * 2 * 16 * N * P                 # xᵀ(wB) or C·hᵀ on one 16-row tile
    assert cs.ssd_kernel_work(5) == 48 * (pair + rows)
    assert cs.ssd_kernel_work(64) == 48 * (10 * pair + 4 * rows)
    # 600 rows: nine full chunks and one of 24 rows (two tiles)
    assert cs.ssd_kernel_work(600) == 48 * (9 * (10 * pair + 4 * rows) + 3 * pair + 2 * rows
                                            + 8 * 4 * rows + 2 * rows)
    assert cs.ssd_kernel_work(600, B=2) == 2 * cs.ssd_kernel_work(600)


# ---------------------------------------------------------------------------
# the sampler's check, and the temperature and graph-against-loop phases
# ---------------------------------------------------------------------------


def _sample_case(B=3, V=500, seed=0):
    import numpy as np

    from repro_torch.serve import sampling

    g = torch.Generator().manual_seed(seed)
    logits = torch.randn((B, V), generator=g) * 2
    keys = torch.randint(-2**31, 2**31 - 1, (B, 2), generator=g, dtype=torch.int32)
    counts = torch.randint(0, 1000, (B,), generator=g, dtype=torch.int32)
    live = torch.ones(B, dtype=torch.int32)
    tok, bits = torch.zeros(B, dtype=torch.int32), torch.zeros((B, V), dtype=torch.int32)
    sample_k.sample(logits, keys, counts, live, tok, 0.7, bits=bits)
    flipped = keys.clone()
    flipped[:, 0] ^= 1 << 7
    fault_bits = torch.zeros_like(bits)
    sample_k.sample(logits, flipped, counts, live, tok.clone(), 0.7, bits=fault_bits)
    want_bits = sampling.random_bits_32(sampling.fold_in(keys, counts), V)
    np_want = cs.np_bits(np, keys.numpy().view(np.uint32), counts.numpy().astype(np.uint32), V)
    return tok, bits, sampling.scores(keys, counts, logits, 0.7), want_bits, np_want, fault_bits


def test_sample_check_passes_the_plain_version_and_sees_a_flipped_key():
    """The sampler's check on the CPU, the plain version standing for the
    kernel: its bits are the numpy Threefry's, its tokens the scores'
    argmax; a bit changed, a token changed or a fault the check cannot see
    fails it."""
    tok, bits, scores, want_bits, np_want, fault_bits = _sample_case()
    res = cs.sample_err(torch, tok, bits, scores, want_bits, np_want, fault_bits)
    assert res["rows_compared"] == 3 and res["planted_fault_bits_differ_share"] > 0.99
    bad = bits.clone()
    bad[1, 7] ^= 1
    with pytest.raises(AssertionError, match="plain version's in 1 elements"):
        cs.sample_err(torch, tok, bad, scores, want_bits, np_want, fault_bits)
    with pytest.raises(AssertionError, match="disagree"):
        cs.sample_err(torch, (tok + 1) % 500, bits, scores, want_bits, np_want, fault_bits)
    with pytest.raises(AssertionError, match="cannot see it"):
        cs.sample_err(torch, tok, bits, scores, want_bits, np_want, bits.clone())
    assert cs.SAMPLE_INT_OPS == 75


def test_sample_shape_check_needs_every_served_shape_and_split():
    """Every [B, V] a sampled run gave the sampler needs a row, and every
    split count its rule picks there must have run; the script's rows
    cover the shapes its sampled runs give (llama's and Mamba-2's
    vocabularies, first tokens and every engine's slots)."""
    runs = [{"sample_shapes": [(1, 128256), (8, 128256)]}, {"sample_shapes": []},
            {"sample_shapes": [(1, 128256), (16, 128256)]},
            {"sample_shapes": [(1, 50280), (8, 50280)]}]
    rows = [{"name": "sample", "shape": f"[{B},{V}]", "splits": sample_k.splits_for(B, V)}
            for B, V in cs.SAMPLE_SHAPES] + [{"name": "rmsnorm", "shape": "[1,50280]"}]
    res = cs.check_sample_shapes(rows, runs, sample_k)
    assert res["served_shapes"] == [(1, 50280), (1, 128256), (8, 50280), (8, 128256),
                                    (16, 128256)]
    assert res["splits"] == sorted({r["splits"] for r in rows if r["name"] == "sample"})
    assert {sample_k.splits_for(*shape) for shape in res["served_shapes"]} == {17, 33, 50, 64}
    with pytest.raises(AssertionError, match=r"no row held .*\(16, 128256\)"):
        cs.check_sample_shapes([r for r in rows if r["shape"] != "[16,128256]"], runs, sample_k)
    wrong = [{**r, "splits": 1} if r["shape"] == "[1,50280]" else r for r in rows]
    with pytest.raises(AssertionError, match="no row ran"):
        cs.check_sample_shapes(wrong, runs, sample_k)
    with pytest.raises(AssertionError, match="no row held"):
        cs.check_sample_shapes(rows, [{"sample_shapes": []}], sample_k)
    vocab = {"llama3.2-1b": 128256, "mamba2-780m": 50280}
    slots = {kw["batch_slots"] for _, kw in cs.TEMPERATURE_RUNS} | {8}   # and busy_phase's
    served = {(B, vocab["llama3.2-1b"]) for B in slots | {1}} | {(1, 50280), (8, 50280)}
    assert served <= set(cs.SAMPLE_SHAPES)
    assert ARCHS["llama3.2-1b"].vocab_size == vocab["llama3.2-1b"]
    assert ARCHS["mamba2-780m"].vocab_size == vocab["mamba2-780m"]


def _counted_sample(monkeypatch):
    plain = sample_k.sample

    def counted(*args, **kwargs):
        sample_k.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(sample_k, "sample", counted)


def test_temperature_phase_streams_equal_across_k_graph_loop_and_policy(monkeypatch):
    """The temperature phase on a small model: T = 0.7 streams equal across
    K 1 and 4, a FusionPolicy, dense and paged and the loop arms (on the
    CPU every arm is the step function called K times), and the sampler's
    launches are one a first token and one a decode step."""
    cfg = reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128)
    model = build_model(cfg, device="cpu")
    params = init_params(model.param_specs(), 0, device="cpu")
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k, sample_k)
    _counted_sample(monkeypatch)
    with dispatch.use(registry=_counting_registry()):
        res = cs.temperature_phase(torch, model, params, kernels, 0)
    runs = res["runs"]
    assert list(runs) == [name for name, _ in cs.TEMPERATURE_RUNS]
    assert res["streams_equal_across_k_and_graph_loop"]
    for run in runs.values():
        assert run["launches"]["sample"] == run["sample_calls"] == 16 + run["decode_calls"]
        assert run["graph"] is None                  # no graphs on the CPU
        assert run["sample_shapes"] == [(1, 128), (run["batch_slots"], 128)]
    assert runs["dense_k4"]["decode_calls"] == runs["dense_k1"]["decode_calls"]
    assert runs["dense_policy"]["decode_fusion"].startswith("FusionPolicy(max_fusion=8")


def test_loop_runs_give_the_graphed_runs_streams_on_a_small_model():
    cfg = reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128)
    model = build_model(cfg, device="cpu")
    params = init_params(model.param_specs(), 0, device="cpu")
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k, sample_k)
    with dispatch.use(registry=_counting_registry()):
        serve = cs.serve_phase(torch, model, params, kernels, 0)
        res = cs.loop_streams_equal(torch, model, params, kernels, 0, serve["streams"],
                                    cs.SERVE_RUNS[1:])
        streams = dict(serve["streams"])
        streams["paged"] = [s[:-1] + [(s[-1] + 1) % 128] for s in streams["paged"]]
        with pytest.raises(AssertionError, match="paged: the loop's streams differ"):
            cs.loop_streams_equal(torch, model, params, kernels, 0, streams, cs.SERVE_RUNS[1:2])
    assert set(res) == {"paged", "paged_chunked"}
    assert all(not r["graphed"] for r in res.values())


def test_union_counts_overlapping_kernel_spans_once():
    """Kernels launched with programmatic dependent launch overlap the one
    ahead; the busy union counts such time once, the sum twice."""
    from types import SimpleNamespace as NS

    def ev(start, end):
        return NS(time_range=NS(start=start, end=end))

    spans = [ev(0, 10), ev(8, 12), ev(12, 15), ev(20, 21), ev(20.5, 20.8)]
    assert cs.union_us(spans) == 16
    assert cs.union_us([]) == 0


def test_trace_steps_split_at_the_marker_kernels():
    """A trace splits into steps at each ``spin_kernel`` (the marker
    launched before a step); kernels before the first marker, and the
    markers themselves, count in no step."""
    from types import SimpleNamespace as NS

    def ev(t, name):
        return NS(device_type="DeviceType.CUDA", name=name, time_range=NS(start=t, end=t + 1))

    names = ["mm_stream_kernel<8>", "spin_kernel", "rmsnorm_kernel<>", "mm_stream_kernel<8>",
             "sample_kernel", "spin_kernel", "rmsnorm_kernel<>", "spin_kernel",
             "mm_tile_kernel<1,2>", "dec_kernel<64, DenseRows>"]
    prof = NS(events=lambda: [ev(t, n) for t, n in reversed(list(enumerate(names)))])
    steps = cs.trace_steps(prof, cs.TRACE_KERNELS, 2)
    assert [{k: v for k, v in st.items() if v} for st in steps] == [
        {"rmsnorm": 1}, {"matmul": 1, "decode_attention": 1}]
    assert len(cs.trace_steps(prof, cs.TRACE_KERNELS, 5)) == 3


def test_matmul_row_invariance_check_takes_the_served_launch_rows():
    """The matmul row-invariance check on the plain version: a 1024-row
    launch's rows against launches of 1, 3, 8, 16, 17 and 128 rows and a
    permutation, at a served (K, N) scaled down."""
    g = torch.Generator().manual_seed(3)
    x, w = _randn(g, 1024, 64), _randn(g, 64, 32)
    perm = torch.randperm(1024, generator=g)
    res = cs.row_invariance(torch, mm_k.plain_matmul, x, w, perm, rows=cs.MATMUL_INVARIANCE_ROWS)
    assert res["launch_rows"] == [1, 3, 8, 16, 17, 128] and res["rows"] == 1024


def test_flash_chunk_invariance_check_reads_where_a_chunk_starts():
    """The flash chunk check: a row-local function's chunked rows equal the
    whole prompt's; one whose rows depend on the launch's query count
    fails."""
    g = torch.Generator().manual_seed(4)
    q, k, v = _randn(g, 1, 4, 1024, 16), _randn(g, 1, 2, 1024, 16), _randn(g, 1, 2, 1024, 16)

    def plain(q, k, v, causal, splits=None):
        # a row-local stand-in (CPU BLAS sums depend on the shape): query row
        # i against the running sum of keys 0..i, aligned to the keys' end
        keys = k.float().cumsum(2).repeat_interleave(q.shape[1] // k.shape[1], 1)
        return (q.float() * keys[:, :, k.shape[2] - q.shape[2]:]).to(q.dtype)

    res = cs.flash_chunk_invariance(torch, plain, q, k, v, (1, 2))
    assert res["chunk_starts"] == [0, 16, 128, 512] and res["splits"] == ["rule", 1, 2]

    def by_rows(q, k, v, causal, splits=None):
        return plain(q, k, v, causal) + q.shape[2] * 1e-2

    with pytest.raises(AssertionError, match="16-row chunk at 0"):
        cs.flash_chunk_invariance(torch, by_rows, q, k, v, (1,))


def test_traffic_rows_are_checked_against_the_jax_package():
    """The traffic phase's gates: a row that differs from the JAX package's
    in any number, or a chunked stream that differs from its whole stream,
    raises."""
    from repro_torch.bench import table9_traffic as t9

    def result(row, streams):
        return {"ttft_p50": row["ttft_p50_us"] * 1e-6, "ttft_p99": row["ttft_p99_us"] * 1e-6,
                "tpot_p50": row["tpot_p50_us"] * 1e-6, "tpot_p99": row["tpot_p99_us"] * 1e-6,
                "throughput": row["throughput_tok_s"], "makespan": row["makespan_us"] * 1e-6,
                "requests": row["requests"], "streams": streams}

    good = {key: result(row, {1: [5, 6]}) for key, row in t9.EXPECTED.items()}
    t9.check_rows(good)
    late = dict(good)
    late[("bursty", "chunked")] = {**good[("bursty", "chunked")], "ttft_p99": 8401e-6}
    with pytest.raises(AssertionError, match="bursty chunked"):
        t9.check_rows(late)
    parted = dict(good)
    parted[("poisson", "chunked")] = {**good[("poisson", "chunked")], "streams": {1: [5, 7]}}
    with pytest.raises(AssertionError, match="diverged .* on poisson"):
        t9.check_rows(parted)


def test_decode_split_check_covers_the_traffic_phase_step():
    """The decode kernels' served split counts include the traffic phase's
    6-slot step against 256 rows, whose count a kernel-phase row runs."""
    served = cs.served_decode_splits(dec_k, [5, 600])
    assert dec_k.split_kv(256) == 1 and 1 in served["decode_attention"]
