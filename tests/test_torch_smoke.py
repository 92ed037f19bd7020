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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The small models' ops gain nothing from threads, and beside other
    test workers torch's default threads oversubscribe the cores and slow
    every worker many times over: one while this file runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    matmul TMA cannot take counted as the edge kernel's, one of f32 inputs
    as the f32 kernel's); ``with_others``
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
            if _mod is mm_k and args[0].dtype == torch.float32:
                mm_k.f32_launches += 1
            elif _mod is mm_k and not mm_k.tma_ready(*args[:2]):
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
    """The model-call check of the full-depth phase on a small
    granite-shaped model (head_dim 128, 4 query heads a kv head, an untied
    unembed over an odd vocabulary): the calls run, the paged decode and
    paged chunks equal the dense and staging ones bit for bit, the logits
    agree with the torch source, and the launch counts it checks hold (plain
    versions counted as launches; the unembed as the edge kernel's)."""
    import dataclasses

    cfg = dataclasses.replace(reduced(ARCHS["granite-3-8b"], layers=2, d_model=64, vocab=131),
                              head_dim=128)
    model = build_model(cfg, device="cpu")
    params = init_params(model.param_specs(), 0, device="cpu")
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k, sample_k)
    with dispatch.use(registry=_counting_registry(with_others=True)):
        res = cs.model_calls_phase(torch, model, params, kernels, 0)
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
                               "sample": 0, "matmul_edge": 0}
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


def test_edge_sass_names_the_edge_tile_kernel_and_refuses_it_without_wgmma(monkeypatch):
    """The edge kernels' counts: the streaming instances by their template
    arguments (mma.sync), the edge tile kernel by its name (wgmma and TMA);
    an edge tile kernel without wgmma fails."""
    sass = """
        Function : _ZN41_GLOBAL__N__1_matmul_cu_2_21mm_edge_stream_kernelILi8ELb1EEEv14CUtensorMap_st
        /*0100*/ UTMALDG.2D [UR8], [UR4] ;
        /*0200*/ HMMA.16816.F32.BF16 R24, R4, R8, R24 ;
        Function : _ZN41_GLOBAL__N__1_matmul_cu_2_19mm_edge_tile_kernelILi128EEEv14CUtensorMap_stS1_
        /*0100*/ UTMALDG.2D [UR8], [UR4] ;
        /*0110*/ UTMALDG.2D [UR12], [UR4] ;
        /*0200*/ HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24 ;
"""

    class Native:
        def build_all(self):
            return {"matmul": Path("libmatmul.so")}

        def _nvcc(self):
            return "/cuda/bin/nvcc"

    monkeypatch.setattr(cs.subprocess, "run", lambda cmd, **kw: subprocess.CompletedProcess(
        cmd, 0, stdout=sass, stderr=""))
    assert cs.edge_sass(Native()) == {
        "mm_edge_stream_kernel<8,1>": {"HGMMA": 0, "UTMALDG": 1, "HMMA": 1},
        "mm_edge_tile_kernel<128>": {"HGMMA": 1, "UTMALDG": 2}}
    sass = sass.replace("HGMMA.64x128x16", "HMMA.16816")
    with pytest.raises(AssertionError, match="without wgmma"):
        cs.edge_sass(Native())


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
    """Every matmul instance ``cuobjdump`` lists, and the edge tile kernel,
    must have run in some kernel-phase row."""
    sass = {"matmul": {"mm_stream_kernel<8>": {}},
            "matmul_edge": {"mm_edge_stream_kernel<8,0>": {}},
            "matmul_f32": {"mm_f32_kernel<0,64,64>": {}}}
    tiles = [{"name": "matmul_edge", "instance": i} for i in cs.EDGE_TILE_INSTANCES]
    rows = [{"name": "matmul", "instance": "mm_stream_kernel<8>"},
            {"name": "matmul_edge", "instance": "mm_edge_stream_kernel<8,0>"},
            *tiles,
            {"name": "matmul_f32", "instance": "mm_f32_kernel<0,64,64>"},
            {"name": "rmsnorm"}]
    assert cs.check_instances(rows, sass) == {"mm_stream_kernel<8>", "mm_edge_stream_kernel<8,0>",
                                              *cs.EDGE_TILE_INSTANCES, "mm_f32_kernel<0,64,64>"}
    for drop in range(len(rows) - 1):
        with pytest.raises(AssertionError, match="never held against"):
            cs.check_instances(rows[:drop] + rows[drop + 1:], sass)


def test_instance_check_refuses_a_built_decode_or_ssd_instance_no_row_ran():
    """The decode attention instances and the ssd kernel that ``cuobjdump``
    lists are held the same way as the matmul's."""
    sass = {"matmul": {}, "matmul_edge": {}, "matmul_f32": {},
            "decode_attention": {"dec_kernel<64,DenseRows>": {}, "dec_kernel<64,PagedRows>": {}},
            "ssd": {"ssd_kernel": {}}}
    tiles = [{"name": "matmul_edge", "instance": i} for i in cs.EDGE_TILE_INSTANCES]
    rows = [*tiles,
            {"name": "decode_attention", "instance": "dec_kernel<64,DenseRows>"},
            {"name": "paged_decode_attention", "instance": "dec_kernel<64,PagedRows>"},
            {"name": "ssd", "instance": "ssd_kernel"}]
    cs.check_instances(rows, sass)
    for drop in range(len(tiles), len(rows)):
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
    over 1024, 512 and 256 rows, every fixup; hymba's 1024-row ring,
    whisper's 448 self-attention rows and its 1500 memory rows: 6 splits)
    must each run in some row of the kernel."""
    lengths, _ = cs.serve_prompts(torch, 128, 0)
    served = cs.served_decode_splits(dec_k, lengths)
    assert served == {"decode_attention": {1, 2, 3, 4, 6}, "paged_decode_attention": {2, 4}}
    rows = ([{"name": "decode_attention", "splits": n} for n in (1, 2, 3, 4, 6)]
            + [{"name": "paged_decode_attention", "splits": n} for n in (2, 4)])
    assert cs.check_splits(rows, served) == {"decode_attention": [1, 2, 3, 4, 6],
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
    # the bound's operations an element, read off the probe kernel's SASS:
    # a rotate, a xor, an add (IADD3 or IMAD), the key's add, the prologue
    sass = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   ULDC.64 UR4, c[0x0][0x218] ;
        /*0050*/                   VIADD R2, R0, UR5 ;
        /*0070*/                   SHF.L.W.U32.HI R2, R2, 0xd, R2 ;
        /*0090*/                   LOP3.LUT R2, R2, R3, RZ, 0x3c, !PT ;
        /*00a0*/                   IMAD.IADD R3, R3, 0x1, R2.reuse ;
        /*0140*/                   IADD3 R3, R2.reuse, UR4, R3 ;
        /*0150*/              @!P0 SHF.R.U32.HI R2, RZ, 0x9, R2 ;
        /*0160*/                   IMAD.WIDE.U32 R4, R0, 0x4, R4 ;
        /*0170*/                   STG.E desc[UR4][R4.64], R2 ;
        /*0180*/                   EXIT ;
        /*0190*/                   BRA 0x190;
"""
    assert cs.sample_element_ops(sass) == {"alu_only": 3, "issued": 6, "slots": 6}


def test_sample_shape_check_needs_every_served_shape_and_split():
    """Every [B, V] a sampled run gave the sampler needs a row, and every
    split count its rule picks there must have run; the script's rows
    cover the shapes its sampled runs give (llama's and Mamba-2's
    vocabularies, first tokens and every engine's slots)."""
    runs = [{"sample_shapes": [(1, 128256), (8, 128256)]}, {"sample_shapes": []},
            {"sample_shapes": [(1, 128256), (16, 128256)]},
            {"sample_shapes": [(1, 50280), (8, 50280)]}]
    rows = [{"name": "sample", "shape": f"[{B},{V}]", "splits": sample_k.splits_for(B, V)}
            for B, V in sample_k.SHAPES] + [{"name": "rmsnorm", "shape": "[1,50280]"}]
    res = cs.check_sample_shapes(rows, runs, sample_k)
    assert res["served_shapes"] == [(1, 50280), (1, 128256), (8, 50280), (8, 128256),
                                    (16, 128256)]
    assert res["splits"] == sorted({r["splits"] for r in rows if r["name"] == "sample"})
    assert {sample_k.splits_for(*shape) for shape in res["served_shapes"]} == {16, 33, 132}
    with pytest.raises(AssertionError, match=r"no row held .*\(16, 128256\)"):
        cs.check_sample_shapes([r for r in rows if r["shape"] != "[16,128256]"], runs, sample_k)
    one_slot = sample_k.splits_for(1, 50280)      # every first token's split count
    wrong = [{**r, "splits": 1} if r.get("splits") == one_slot else r for r in rows]
    with pytest.raises(AssertionError, match="no row ran"):
        cs.check_sample_shapes(wrong, runs, sample_k)
    with pytest.raises(AssertionError, match="no row held"):
        cs.check_sample_shapes(rows, [{"sample_shapes": []}], sample_k)
    vocab = {"llama3.2-1b": 128256, "mamba2-780m": 50280}
    slots = {kw["batch_slots"] for _, kw in cs.TEMPERATURE_RUNS} | {8}   # and busy_phase's
    served = {(B, vocab["llama3.2-1b"]) for B in slots | {1}} | {(1, 50280), (8, 50280)}
    assert served <= set(sample_k.SHAPES)
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


def test_served_logits_are_the_ones_the_sampler_is_given(monkeypatch):
    """The untimed run behind the sampler's served-logits row keeps, through
    the engine's decode-logits tap, 16 decode steps' logits, each the very
    tensor the sampler then draws from."""
    cfg = reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128)
    model = build_model(cfg, device="cpu")
    params = init_params(model.param_specs(), 0, device="cpu")
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k, sample_k)
    given = []
    plain = sample_k.sample

    def seen(logits, *args, **kwargs):
        sample_k.launches += 1
        if logits.shape[0] == 8:
            given.append(logits.clone())
        return plain(logits, *args, **kwargs)

    monkeypatch.setattr(sample_k, "sample", seen)
    with dispatch.use(registry=_counting_registry()):
        kept = cs.served_logits(torch, model, params, kernels, 0)
    assert len(kept) == 16 and all(k.shape == (8, 128) and k.dtype == torch.float32
                                   for k in kept)
    assert any(all(torch.equal(k, g) for k, g in zip(kept, given[i:])) for i in range(len(given)))


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
    launch's rows against launches of 1, 3, 8, 16, 17, 128 and 512 rows and
    a permutation, at a served (K, N) scaled down."""
    g = torch.Generator().manual_seed(3)
    x, w = _randn(g, 1024, 64), _randn(g, 64, 32)
    perm = torch.randperm(1024, generator=g)
    res = cs.row_invariance(torch, mm_k.plain_matmul, x, w, perm, rows=cs.MATMUL_INVARIANCE_ROWS)
    assert res["launch_rows"] == [1, 3, 8, 16, 17, 128, 512] and res["rows"] == 1024


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


def _small_untied(arch: str, vocab: int, heads: int):
    """A 2-layer model with the arch's heads of 128 (``heads`` query heads
    over one kv head) and its untied unembed over ``vocab`` entries."""
    import dataclasses

    cfg = dataclasses.replace(reduced(ARCHS[arch], layers=2, d_model=64, vocab=vocab),
                              num_heads=heads, num_kv_heads=1, head_dim=128)
    model = build_model(cfg, device="cpu")
    return model, init_params(model.param_specs(), 0, device="cpu")


def test_yi_model_calls_count_the_unembed_as_the_bf16_kernel():
    """yi's unembed (N a multiple of 8) is a bf16 kernel launch a model
    call, counted with the matmuls; no edge launch."""
    model, params = _small_untied("yi-9b", 128, 8)
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k, sample_k)
    with dispatch.use(registry=_counting_registry(with_others=True)):
        res = cs.model_calls_phase(torch, model, params, kernels, 0)
    assert res["launches"]["matmul"] == (7 * 2 + 1) * 26 and res["launches"]["matmul_edge"] == 0
    assert cs.unembed_launches(ARCHS["yi-9b"]) == (1, 0)
    assert cs.unembed_launches(ARCHS["granite-3-8b"]) == (0, 1)
    assert cs.unembed_launches(ARCHS["llama3.2-1b"]) == (0, 0)


def test_full_depth_phase_serves_five_runs_equal_on_a_small_model(monkeypatch):
    """The full-depth phase on a small granite-shaped model: the model calls,
    then the five serve runs with their launch counts (the unembed on the
    edge kernel, the sampler once a first token and a decode step), paged
    and chunked streams equal to dense, T = 0.7 chunked equal to dense.
    Prompts of 5 to 480 tokens: on the CPU the plain versions sum a row in
    an order that may follow the launch's rows (the 1024 bucket's whole
    prompt against its 128-row chunks parts here), which only the kernels
    on the card rule out."""
    model, params = _small_untied("granite-3-8b", 131, 4)
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k, sample_k)
    _counted_sample(monkeypatch)
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, 131, (5 + 475 * i // 15,), generator=gen).tolist()
               for i in range(16)]
    with dispatch.use(registry=_counting_registry(with_others=True)):
        res = cs.full_depth_phase(torch, model, params, kernels, 0, "cpu", "no card",
                                  prompts=prompts)
    runs = res["runs"]
    assert list(runs) == [name for name, _ in cs.FULL_DEPTH_RUNS]
    for run in runs.values():
        calls = (run["prefill_calls"] + run["chunk_calls"] + run["fixup_calls"]
                 + run["decode_calls"])
        assert run["launches"]["matmul_edge"] == calls
    assert runs["t0.7_chunked_k4"]["sample_shapes"] == [(1, 131), (16, 131)]
    # the chunked runs' shapes: 128-row chunks against each chunk's keys
    chunked = set(runs["paged_chunked"]["kernel_shapes"])
    assert ("flash_attention", 128, 512, 1, 128) in chunked
    assert ("paged_decode_attention", 16, 1, 16, 64, 128) in chunked
    assert ("matmul", 16, 64, 131) in chunked                    # the unembed of a step
    assert ("flash_attention", 128, 512, 1, 128) in res["calls"]["kernel_shapes"]
    assert res["summary"]["weights_bytes"] == cs.weight_bytes(params)
    assert res["summary"]["streams_equal"]["paged_chunked"] == "16 of 16 equal dense"


def test_served_shapes_are_read_off_the_kernel_rows():
    """The shapes a yi-9b engine gives its kernels are keys that
    ``row_shape_key`` reads off the kernel phase's shape strings (a windowed
    flash row names no served shape), and ``check_served_shapes`` names a
    served shape that no row held."""
    keys = cs.served_shapes(ARCHS["yi-9b"], [5, 600], slots=16, max_len=1024, paged=True,
                            chunk=128)
    for key in (("matmul", 128, 4096, 11008), ("matmul", 16, 4096, 64000),
                ("matmul", 8, 4096, 512), ("rmsnorm", 1, 4096),
                ("flash_attention", 8, 8, 4, 128), ("flash_attention", 128, 640, 4, 128),
                ("flash_attention", 128, 1024, 4, 128),
                ("paged_decode_attention", 16, 4, 16, 64, 128),
                ("decode_attention", 1, 4, 5, 128), ("decode_attention", 1, 4, 600, 128)):
        assert key in keys
    assert ("decode_attention", 16, 4, 1024, 128) not in keys      # paged: no dense step
    rows = [{"name": "matmul", "shape": "[128,4096]x[4096,11008] act=None out=bfloat16"},
            {"name": "matmul", "shape": "[8,4096]x[4096,11008] act=silu out=bfloat16"},
            {"name": "matmul_edge", "shape": "[8,4096]x[4096,49155] act=None out=float32"},
            {"name": "flash_attention", "shape": "q[1,32,128,128] kv[1,4,640,128] causal=True"},
            {"name": "flash_attention",
             "shape": "q[1,32,256,128] kv[1,8,256,128] causal=True window=48"},
            {"name": "decode_attention", "shape": "q[1,32,128] cache[1,4,5,128] length 5"},
            {"name": "decode_attention",
             "shape": "q[16,32,128] cache[16,8,1024,128] lengths 1..1024"},
            {"name": "paged_decode_attention",
             "shape": "q[8,32,128] pool[513,4,16,128] table[8,64] lengths [1, 1024]"},
            {"name": "rmsnorm", "shape": "[64,4096]"}]
    assert [cs.row_shape_key(r) for r in rows] == [
        ("matmul", 128, 4096, 11008), None, ("matmul", 8, 4096, 49155),
        ("flash_attention", 128, 640, 4, 128), None, ("decode_attention", 1, 4, 5, 128),
        ("decode_attention", 16, 8, 1024, 128), ("paged_decode_attention", 8, 4, 16, 64, 128),
        ("rmsnorm", 64, 4096)]
    runs = [{"kernel_shapes": [("rmsnorm", 64, 4096), ("matmul", 128, 4096, 11008)]},
            {"kernel_shapes": [["rmsnorm", 64, 4096]]}]
    assert cs.check_served_shapes(rows, runs) == {"rmsnorm": 1, "matmul": 1}
    with pytest.raises(AssertionError, match=r"\('rmsnorm', 256, 4096\)"):
        cs.check_served_shapes(rows, [*runs, {"kernel_shapes": [("rmsnorm", 256, 4096)]}])


def test_overcommit_phase_preempts_spills_and_streams_equal_on_a_small_model(monkeypatch):
    """The overcommit phase on a small yi-shaped model, scaled down: the
    overcommitted arm preempts and resumes by snapshot and by re-prefill,
    the tight host arm spills and demotes, the churn arm preempts, every
    arm's streams equal the dense run's, its launches its model calls, and
    the trace arms equal the JAX package's rows.  The tight host arm evicts
    a parked snapshot (a demotion that frees arena bytes) and cancels its
    refill in flight."""
    model, params = _small_untied("yi-9b", 128, 8)
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k, sample_k)
    _counted_sample(monkeypatch)
    # the phase scaled down: prompts of 5 to 150 tokens, 32 new, max_len 256,
    # a pool of 25 pages, snapshots from 100 rows (two never fit the tight
    # host arm's budget of the largest one); at full size it takes a minute
    # here: 97 pages, 128 new tokens, snapshots from 384 rows
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, 128, (round(5 + i * 145 / 15),), generator=gen).tolist()
               for i in range(16)]
    with dispatch.use(registry=_counting_registry(with_others=True)):
        res = cs.overcommit_phase(torch, model, params, kernels, 0, "cpu", "no card",
                                  prompts=prompts, new_tokens=32, pool_pages=26,
                                  snapshot_tokens=100, max_len=256)
    runs = res["runs"]
    assert list(runs) == ["dense_16", "dense_16_t0.7", "full_reserve", "overcommit",
                          "tight_host", "churn_t0.7"]
    assert runs["full_reserve"]["tier"]["preemptions"] == 0
    over = runs["overcommit"]["tier"]
    assert over["snapshot_resumes"] > 0 and over["reprefill_resumes"] > 0
    assert over["copies"]["d2h_bytes"] == over["copies"]["h2d_bytes"] > 0
    tight = runs["tight_host"]["tier"]
    assert tight["demotions"] > 0 and tight["demoted_bytes"] > 0
    assert tight["refill_cancels"] > 0 and tight["copies"]["h2d_cancelled"] == 0
    assert (res["sustained_concurrency"]["overcommit"]
            > res["sustained_concurrency"]["full_reserve"])
    assert set(res["traces"]) == {"table8", "table11"}


def _small_llama():
    model = build_model(reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128),
                        device="cpu")
    return model, init_params(model.param_specs(), 0, device="cpu")


def _prompts(lengths, seed: int):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 128, (n,), generator=gen).tolist() for n in lengths]


def test_faults_phase_recovers_every_arm_on_a_small_model(monkeypatch):
    """The faults phase scaled down (prompts of 5 to 40 tokens, 6 new,
    max_len 64): every arm's streams equal the fault-free run's (the
    permanent arm's survivors), its launches its model calls; the decode
    fault parks and re-prefills, the scheduler's retry absorbs its fault,
    the permanent fault fails the first slots' requests, Table X's plan
    faults and recovers; the counts are the CPU run's the card is held
    to."""
    model, params = _small_llama()
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k, sample_k)
    _counted_sample(monkeypatch)
    prompts = _prompts([round(5 + i * 35 / 15) for i in range(16)], 5)
    with dispatch.use(registry=_counting_registry(with_others=True)):
        res = cs.faults_phase(torch, model, params, kernels, 0, prompts=prompts, new_tokens=6,
                              max_len=64)
    runs = res["runs"]
    assert list(runs) == [f"{s}_{a[0]}" for s, _ in cs.GATE_SAMPLINGS for a in cs.FAULT_ARMS]
    for s, _ in cs.GATE_SAMPLINGS:
        assert runs[f"{s}_decode_fault"]["tier"]["preemptions"] == 8
        assert runs[f"{s}_sched_retry"]["tier"]["preemptions"] == 0
        assert runs[f"{s}_permanent"]["recovery"]["failed"] == list(range(1, 9))
        assert runs[f"{s}_permanent"]["survivors"] == 8
        assert runs[f"{s}_table10"]["splits"]["availability_split"]["faults"] > 0
        chunk = runs[f"{s}_chunk_fault"]
        assert chunk["chunk_calls"] == 16 and sum(chunk["recovery"]["fault_recoveries"]) == 1
    assert res["counts"]["greedy_decode_fault"]["trace"] == [
        ("exec", "decode_fused_k1_paged", False, True)]
    # a second run of the phase gives the same counts (what the card's are
    # compared with comes from such a run)
    with dispatch.use(registry=_counting_registry(with_others=True)):
        again = cs.faults_phase(torch, model, params, kernels, 0, prompts=prompts,
                                new_tokens=6, max_len=64, twin=True)
    cs.check_counts(res["counts"], again["counts"])


def test_integrity_phase_detects_every_corruption_on_a_small_model(monkeypatch):
    """The integrity phase scaled down (prompts of 5 to 40 tokens, 24 new,
    22 pages, snapshots from 30 rows) at a higher corruption rate: pages,
    arena blocks and transfers corrupted, every corruption detected and
    none escaping, the streams the clean run's; with the checks off the
    corruption escapes.  The hashed bytes a decode launch are the sealed
    pages' bytes."""
    model, params = _small_llama()
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k, sample_k)
    _counted_sample(monkeypatch)
    monkeypatch.setattr(cs, "INTEGRITY_PLAN", {"seed": 0, "corrupt_rate": 0.02})
    prompts = _prompts([round(5 + i * 35 / 15) for i in range(16)], 6)
    with dispatch.use(registry=_counting_registry(with_others=True)):
        res = cs.integrity_phase(torch, model, params, kernels, 0, prompts=prompts,
                                 new_tokens=24, pool_pages=22, snapshot_tokens=30, max_len=64)
    runs = res["runs"]
    assert list(runs) == ["greedy_clean", "greedy_verified", "t0.7_clean", "t0.7_verified",
                          "greedy_verify_off"]
    for s, _ in cs.GATE_SAMPLINGS:
        sp = runs[f"{s}_verified"]["splits"]["integrity_split"]
        assert sp["detected"] == sp["corruptions"] > 0 and sp["escaped"] == 0
        assert runs[f"{s}_verified"]["tier"]["spills"] > 0
        d = res["per_launch"][s]
        cfg = model.cfg         # a page: 16 rows of k and v in every layer, bf16
        page = 16 * cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * 2
        assert d["hashed_bytes"] == pytest.approx(d["hashed_pages"] * page) and page > 0
    assert runs["greedy_verify_off"]["splits"]["integrity_split"]["escaped"] > 0
    assert runs["greedy_clean"]["verify"]["launches"] == 0


def test_prefix_phase_shares_and_streams_equal_on_a_small_model(monkeypatch):
    """The prefix phase scaled down (two personas' 32-token prefixes, 16
    users' suffixes of 8 to 40 tokens, 40 new, max_len 128): the followers
    attach to their persona's pages, whole and chunked, every stream the
    unshared run's; the indexed pages' digests hold while shared; the
    flipped shared page parks and re-prefills its readers, each reader past
    the first a CoW copy."""
    model, params = _small_llama()
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k, sample_k)
    _counted_sample(monkeypatch)
    personas = _prompts([32, 32], 7)
    suffixes = _prompts([round(8 + i * 32 / 15) for i in range(16)], 8)
    prompts = [personas[i % 2] + s for i, s in enumerate(suffixes)]
    with dispatch.use(registry=_counting_registry(with_others=True)):
        res = cs.prefix_phase(torch, model, params, kernels, 0, prompts=prompts, prefix_rows=32,
                              new_tokens=40, max_len=128)
    runs = res["runs"]
    for s, _ in cs.GATE_SAMPLINGS:
        on, off = runs[f"{s}_on"], runs[f"{s}_off"]
        assert on["recovery"]["prefix_hits"] == 14 and off["recovery"]["prefix_hits"] == 0
        assert on["recovery"]["prefix_pages_saved"] == 14 * 2
        assert on["prefill_calls"] + on["chunk_calls"] == 16      # 14 suffix chunks
        assert runs[f"{s}_on_chunked"]["recovery"]["prefix_hits"] >= 12
        flip = res["counts"][f"{s}_on_flip"]["flipped"]
        assert len(flip["readers"]) >= 3
        assert runs[f"{s}_on_flip"]["recovery"]["cow_copies"] == len(flip["readers"]) - 1
    # the suffix prefills' kernel shapes: a chunk of the rest of the bucket
    # from row 32 (the 64 bucket's 32 rows against 64 keys), beside the
    # whole bucket's
    cfg = model.cfg
    shapes = {tuple(k) for k in runs["greedy_on"]["kernel_shapes"]}
    assert {("flash_attention", 32, 64, cfg.num_kv_heads, cfg.head_dim),
            ("flash_attention", 64, 64, cfg.num_kv_heads, cfg.head_dim)} <= shapes
    assert not {k for k in runs["greedy_off"]["kernel_shapes"] if tuple(k)[1:3] == (32, 64)}


@pytest.mark.parametrize("arch,policy", [("llama4-maverick-400b-a17b", "cuda-strict"),
                                         ("deepseek-v3-671b", "cuda")])
def test_moe_phase_serves_its_runs_equal_on_a_small_model(monkeypatch, arch, policy):
    """The moe phase on a reduced llama4-maverick (a (moe, dense) unit) and
    deepseek-v3 (a dense layer, then MoE; MLA): the model calls against the
    torch source with their launch counts (MLA's decode wo on the f32
    kernel) and the dispatch trace (only ``mla_decode_attention`` off the
    kernels, and only for MLA), every kernel held against its plain version
    on the calls' data, then the runs, streams equal per MOE_EQUAL (paged
    for GQA only), each run's launches equal to its calls'.  Prompts of 5
    to 120 tokens (the phase's are 5 to 600)."""
    cfg = reduced(ARCHS[arch], layers=2, d_model=64, vocab=128)
    model = build_model(cfg, device="cpu")
    params = init_params(model.param_specs(), 0, device="cpu")
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k, sample_k)
    _counted_sample(monkeypatch)
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, 128, (5 + 115 * i // 7,), generator=gen).tolist()
               for i in range(8)]
    with dispatch.use(registry=_counting_registry(with_others=True)):
        res = cs.moe_phase(torch, model, params, policy, kernels, 0, "cpu", "no card",
                           full_layers=ARCHS[arch].num_layers, prompts=prompts)
    calls, runs = res["calls"], res["runs"]
    mla = cfg.mla is not None
    assert calls["off_the_kernels"] == ({"mla_decode_attention": ["torch"]} if mla else {})
    held = calls["kernels_held_against_plain"]
    assert held["matmul"] > 0 and held["rmsnorm"] > 0 and held["flash_attention"] > 0
    assert ("decode_attention" in held) != mla and ("paged_decode_attention" in held) != mla
    L, fix = 2, len(calls["fixup"]["rel_l2"])
    want = cs.moe_launches(model, prefills=8, fixups=fix, decodes=cs.MOE_DECODE_STEPS)
    if mla:
        assert calls["launches"]["matmul_f32"] == L * (fix + cs.MOE_DECODE_STEPS)
        assert want["decode_attention"] == 0 and want["rmsnorm"] == (4 * L + 1) * (8 + fix + 3)
    else:
        assert calls["paged_equal_dense_bitwise"]
    assert list(runs) == [n for n, kw in cs.MOE_RUNS if not (mla and kw.get("paged"))]
    for run in runs.values():
        assert run["requests"] == 8 and run["new_tokens_each"] == cs.MOE_NEW_TOKENS
        assert run["launches"]["matmul"] > 0
    assert runs["dense_loop"]["graphed"] is False
    assert res["summary"]["weights_bytes"] == cs.weight_bytes(params)
    assert res["summary"]["streams_equal"]["t0.7_k4"] == "8 of 8 equal t0.7_k1"
    assert cs.MOE_LENGTHS == (5, 90, 175, 260, 345, 430, 515, 600)


def test_families_phase_serves_hymba_and_runs_whisper_on_small_models(monkeypatch):
    """The families phase on reduced hymba (window 32: prompts of 3 to 60
    tokens, 40, 50 and 60 past the window, 30 crossing it in decode) and
    reduced whisper (8 frames, 2 sequences, 5 greedy tokens): the model
    calls against the torch source with their launch counts, every kernel
    (ssd's state too) held against its plain version, paged and chunked
    serving refused, the runs' streams equal per HYMBA_EQUAL, the two greedy
    decodes equal, and the engine's refusal of whisper; and every shape the
    runs gave a kernel logged for the summary's check."""
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k, sample_k)
    _counted_sample(monkeypatch)
    given = {}
    for arch in ("hymba-1.5b", "whisper-large-v3"):
        model = build_model(reduced(ARCHS[arch], layers=2, d_model=64, vocab=131), device="cpu")
        given[arch] = (model, init_params(model.param_specs(), 0, device="cpu"))
    lengths = (3, 10, 20, 30, 33, 40, 50, 60)
    with dispatch.use(registry=_counting_registry(with_others=True)):
        res = cs.families_phase(torch, kernels, 0, "cpu", "no card",
                                hymba=given["hymba-1.5b"], whisper=given["whisper-large-v3"],
                                hymba_kw={"lengths": lengths, "max_len": 128, "new_tokens": 6},
                                whisper_kw={"batch": 2, "cache_len": 16, "new_tokens": 5})
    hymba, whisper = res["hymba-1.5b"], res["whisper-large-v3"]
    held = hymba["calls"]["kernels_held_against_plain"]
    assert held["ssd"] > 0 and held["flash_attention"] > 0 and held["decode_attention"] > 0
    # d_model 64: in_proj's N is 296, so only the unembed (vocabulary 131) is
    # the edge kernel's: once a call
    assert hymba["calls"]["launches"]["matmul_edge"] == 8 + cs.FAMILY_DECODE_STEPS
    assert list(hymba["runs"]) == [name for name, _ in cs.HYMBA_RUNS]
    for run in hymba["runs"].values():
        assert run["requests"] == 8 and run["fixup_calls"] == 0
        assert run["launches"]["ssd"] == 2 * run["prefill_calls"]
    summary = hymba["summary"]
    assert summary["streams_equal"]["t0.7_k4"] == "8 of 8 equal t0.7_k1"
    assert set(summary["refused"]) == {"paged", "prefill_chunk"} and summary["cache_rows"] == 32
    assert whisper["summary"]["greedy_decodes_equal"] and "EncDecLM" in whisper["summary"][
        "refused"]
    assert whisper["launches"]["flash_attention"] == 2 + 2 * 2
    assert whisper["launches"]["decode_attention"] == 2 * 2 * cs.FAMILY_DECODE_STEPS
    keys = {tuple(k) for k in res["shape_keys"]}
    assert ("flash_attention", 1, 4, 60, 16, 1, 60, 16, True, 32) in keys
    assert ("flash_attention", 2, 4, 8, 16, 4, 8, 16, False, None) in keys      # the encoder
    assert ("decode_attention", 2, 4, 16, 4, 8) in keys             # across to the memory
    assert ("ssd", 1, 60, 8, 16, 1, 16) in keys
    rows = [{"served_key": list(k)} for k in keys]
    assert cs.check_family_shapes(rows, res["shape_keys"])["ssd"] == len(lengths)
    with pytest.raises(AssertionError, match="no row held"):
        cs.check_family_shapes(rows[1:], res["shape_keys"])
    assert cs.hybrid_launches(ARCHS["hymba-1.5b"], prefills=1, decodes=0)["matmul_edge"] == 33


def _served_key(key: tuple) -> tuple:
    """A logged call's key (``call_key``) as ``served_shapes`` writes it."""
    op = key[0]
    if op == "matmul":
        return key[:4]
    if op == "rmsnorm":
        return key[:3]
    if op == "flash_attention":          # B, Hq, S, D, Hkv, T, Dv, causal, window
        return (op, key[3], key[6], key[5], key[4])
    return (op, key[1], key[4], key[5], key[3])          # decode: B, Hkv, T, D


def test_internvl2_phase_serves_and_runs_the_vlm_path_on_a_small_model(monkeypatch):
    """The internvl2 phase on reduced internvl2-76b (2 layers, untied): the
    vlm path's 8 patch rows over the first of 16, 5 greedy steps, against
    the torch source with its launch counts and every kernel held against
    its plain version; the text prompts as graph and loop arms, streams
    equal; the shapes it gives the kernels are ``vlm_shapes``' and
    ``served_shapes``' (what ``internvl2_rows`` holds on the card)."""
    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k, sample_k)
    _counted_sample(monkeypatch)
    cfg = reduced(ARCHS["internvl2-76b"], layers=2, d_model=64, vocab=136)
    assert not cfg.tie_embeddings and cfg.frontend == "vision_patches"
    model = build_model(cfg, device="cpu")
    params = init_params(model.param_specs(), 0, device="cpu")
    log = cs.ShapeLog()
    lengths = (3, 8, 10, 16, 20, 30, 33, 40)
    with dispatch.use(registry=_counting_registry(with_others=True)):
        res = cs.internvl2_phase(torch, model, params, kernels, 0, "cpu", "no card",
                                 shape_log=log, full_layers=80, lengths=lengths, max_len=64,
                                 new_tokens=6, patches=8, text=8, vlm_steps=5)
    calls, summary = res["calls"], res["summary"]
    assert calls["launches"] == cs.dense_launches(cfg, prefills=1, decodes=5)
    assert calls["kernels_held_against_plain"]["flash_attention"] > 0
    assert max(calls["prefill"]["rel_l2"] + calls["decode"]["rel_l2"]) <= cs.MODEL_REL_L2_TOL
    assert {_served_key(k) for k in log.keys} == cs.vlm_shapes(cfg, 16, 5)
    assert {tuple(k) for k in calls["vlm_rows"]["kernel_shapes"]} == cs.vlm_shapes(cfg, 16, 5)
    assert list(res["runs"]) == ["dense", "dense_loop"]
    for run in res["runs"].values():
        assert run["requests"] == 8 and run["new_tokens_each"] == 6
        assert {tuple(k) for k in run["kernel_shapes"]} == cs.served_shapes(
            cfg, lengths, slots=8, max_len=64)
    assert summary["streams_equal"] == "8 of 8 loop equal graph"
    assert summary["reduced"] == {"num_layers": [80, 2]}


def test_internvl2_rows_cover_every_served_shape_at_full_width():
    """The keys ``internvl2_rows`` makes rows for, at internvl2-76b's full
    width: the engine's and the vlm path's, with the matmul rows the issue
    names (d_model 8192 against 8192, 1024, 28672; 28672 against 8192; the
    unembed against 128256), attention at D = 128 in groups of 8, rmsnorm
    at 8192."""
    cfg = ARCHS["internvl2-76b"]
    keys = cs.served_shapes(cfg, cs.INTERNVL_LENGTHS, slots=8, max_len=cs.INTERNVL_MAX_LEN)
    keys |= cs.vlm_shapes(cfg, cs.INTERNVL_PATCHES + cs.INTERNVL_TEXT, cs.INTERNVL_VLM_STEPS)
    kn = {(k[2], k[3]) for k in keys if k[0] == "matmul"}
    assert kn == {(8192, 8192), (8192, 1024), (8192, 28672), (28672, 8192), (8192, 128256)}
    assert {k[1] for k in keys if k[0] == "matmul"} == {1, 8, 64, 128, 256, 320, 512, 1024}
    assert {(k[3], k[4]) for k in keys if k[0] == "flash_attention"} == {(8, 128)}
    assert {k[4] for k in keys if k[0] == "decode_attention"} == {128}
    assert {k[2] for k in keys if k[0] == "rmsnorm"} == {8192}
    assert ("decode_attention", 8, 8, 1024, 128) in keys
    assert ("decode_attention", 1, 8, 352, 128) in keys


def test_dryrun_phase_holds_the_bound_and_the_live_bytes():
    """The dryrun phase's gates on one step counted here (llama3.2-1b at
    full width, one layer, a decode step of 2 slots over 64 rows): a
    measured time at the bound and the live bytes equal pass; a time below
    the bound, or other live bytes, raise."""
    recs = cs.dryrun_records({"step": ("llama3.2-1b", 1, ("d", 64, 2, "decode"))})
    rec = recs["step"]
    assert rec["status"] == "ok" and rec["memory"]["opt_state_bytes"] == 0
    model = build_model(__import__("dataclasses").replace(ARCHS["llama3.2-1b"], num_layers=1),
                        device="cpu")
    live = cs.weight_bytes(init_params(model.param_specs(), 0, device="cpu"))
    assert rec["memory"]["param_bytes"] == live
    bound = rec["roofline"]["step_bound_s"]
    ok = cs.dryrun_phase(torch, recs, {"step": {"s": bound, "from": "test"}}, {"step": live},
                         "cpu", "no card")
    assert ok["step"]["bound_share"] == 1.0
    with pytest.raises(AssertionError, match="above the measured"):
        cs.dryrun_phase(torch, recs, {"step": {"s": bound * 0.99, "from": "test"}},
                        {"step": live}, "cpu", "no card")
    with pytest.raises(AssertionError, match="the card holds"):
        cs.dryrun_phase(torch, recs, {"step": {"s": bound, "from": "test"}},
                        {"step": live + 2}, "cpu", "no card")
    assert cs.busy_measured({"device_busy_us": 4000.0, "device_union_us": 3600.0,
                             "untraced_wall_us": 9000.0}, 4)["s"] == pytest.approx(0.9e-3)
    assert cs.busy_measured({"device_busy_us": 4000.0, "untraced_wall_us": 9000.0}, 4)["s"] \
        == pytest.approx(1e-3)
    assert cs.busy_measured({"device_busy_us": None, "untraced_wall_us": 8000.0}, 4)["s"] \
        == pytest.approx(2e-3)
