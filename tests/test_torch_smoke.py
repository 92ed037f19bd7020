"""``chip_smoke.py``'s own checks, on the CPU.

The script holds each attention kernel to its plain version row by row
(relative L2 over the head dim) and reads a planted fault — one key tile
dropped — by the same measure; these tests show, at a small size, that the
plain versions pass that check, that the planted fault lies beyond its limit
and fails it, that the model phase runs the engine's calls, and that the
script refuses to run without a card.  This file imports no JAX.
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
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ref
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


CASES = {"flash_causal": lambda: _flash_case(True), "flash_full": lambda: _flash_case(False),
         "decode": _decode_case}


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
    assert [len(res[k]["rel_l2"]) for k in ("prefill", "fixup", "decode")] == [4, 3, 4]
    assert max(max(res[k]["rel_l2"]) for k in ("prefill", "fixup", "decode")) < 0.05


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
