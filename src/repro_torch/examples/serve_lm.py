"""Serving with multi-tenant accelerator sharing, on the port
(``examples/serve_lm.py``'s): the paper's §III pitch.

A batched LM serving engine (continuous batching over fixed slots) runs
alongside a second producer submitting pre/post-processing conv jobs to
the same HSA agent: the accelerator "is not monopolized by the network
and can be used for other tasks like pre- and post-processing steps."

The engine runs with ``decode_fusion=4``: each launch runs 4 decode steps
with sampling on the device, so the per-launch invocation overhead (paper
Table II row 3) is paid once per 4 tokens, with token streams equal to
unfused decoding (checked).  It also runs **paged** at equal KV memory: the
dense engine's 4 slots x 96 rows as a pool of 24-row pages shared by up to
8 requests, with streams equal to the dense engine's and the ledger's
reserved/used/stranded split; then overcommitted (growth_reserve 0.5,
preemption) and tiered (a host arena of 4096 bytes, spill, refill and
demotion), streams equal throughout.  The JAX script also counts its
prefill traces bucketed and not; the port compiles nothing per shape, so
that line has no counterpart.

Every model call runs under ``--policy`` (``cuda-strict`` by default: the
hand-written kernels on the card, their plain versions on the CPU); the
conv tenant runs the hand-written int16 conv2d on the card.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu] [--small]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.kernels.ops  # noqa: F401  (registers the reference/torch/cuda sources)
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.core.hsa import hsa_init, hsa_shut_down
from repro_torch.core.ledger import OverheadLedger
from repro_torch.core.policy import AdmissionPolicy, PreemptionPolicy, SpillPolicy
from repro_torch.core.registry import GLOBAL_REGISTRY, KernelImpl
from repro_torch.core.roles import ArgSpec
from repro_torch.kernels import conv2d as conv_k
from repro_torch.models import build_model, init_params
from repro_torch.models.params import resolve_device
from repro_torch.serve.engine import ServeEngine

PROMPTS = ([1, 17, 33, 7], [2, 5], [9, 9, 9, 9, 9, 9], [4, 44, 14], [21, 12])


def _streams(done) -> dict[int, list[int]]:
    return {r.uid: list(r.generated) for r in done}


def run(device: "str | torch.device" = "cuda", small: bool = False, verbose: bool = True,
        policy: str = "cuda-strict") -> dict:
    dev = resolve_device(device)
    say = print if verbose else (lambda *a, **k: None)
    new_tokens = 6 if small else 12
    cfg = reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64 if small else 128,
                  vocab=128 if small else 512)
    model = build_model(cfg, device=dev)
    params = init_params(model.param_specs(), 7, device=dev)

    def engine(**kw) -> ServeEngine:
        kw = {"batch_slots": 4, "max_len": 96, "temperature": 0.0, **kw}
        eng = ServeEngine(model, params, device=dev, **kw)
        for p in PROMPTS:
            eng.submit(list(p), max_new_tokens=new_tokens)
        return eng

    with dispatch.use(prefer=dispatch.policy_from_flag(policy)):
        eng = engine(decode_fusion=4)

        # --- a second producer on the same agent (sensor-fusion conv jobs) ----
        ledger = OverheadLedger()
        hsa_shut_down()
        sys_ = hsa_init(num_regions=2, ledger=ledger, device=dev)
        try:
            ones = torch.ones((3, 3, 1, 1), dtype=torch.int16, device=dev)
            fn = (lambda x: conv_k.conv2d(x, ones))
            conv_impl = KernelImpl(op="sensor_conv", device_kind="any",
                                   source="cuda" if dev.type == "cuda" else "torch", fn=fn)
            GLOBAL_REGISTRY.register(conv_impl, allow_override=True)
            conv_role = sys_.library.make_role(conv_impl, (ArgSpec((1, 32, 32, 1), torch.int16),),
                                               name="sensor_conv", device=dev)
            sys_.library.synthesize_all()
            agent = sys_.default_agent
            q, ex = sys_.queue_of(agent), sys_.executor_of(agent)

            rng = np.random.default_rng(0)
            done, frames, step, conv_ok = [], 0, 0, True
            while True:
                done += eng.step()         # one fused wave: up to 4 tokens a slot
                # interleave: the "OpenCL" producer pushes a camera frame each step
                frame = torch.tensor(rng.integers(-99, 99, size=(1, 32, 32, 1)),
                                     dtype=torch.int16, device=dev)
                pkt = q.dispatch(conv_role.key, frame, producer="opencl")
                ex.drain(q)
                pkt.completion.wait_eq(0)
                if pkt.out.error is not None:
                    raise pkt.out.error
                want = conv_k.plain_conv2d(frame.cpu(), ones.cpu())
                conv_ok &= torch.equal(pkt.out.value.cpu(), want)
                frames += 1
                step += 1
                if (not eng._active and not eng._queue) or step > 200:
                    break
        finally:
            hsa_shut_down()
        tokens = sum(len(r.generated) for r in done)
        say(f"served {len(done)} requests ({tokens} tokens in {step} fused decode waves) "
            f"alongside {frames} conv frames on one agent ({agent.name}); every frame "
            f"equal to the plain conv2d: {conv_ok}")
        if len(done) != len(PROMPTS) or not conv_ok:
            raise AssertionError("the two tenants did not both finish correctly")
        dense = _streams(done)

        # fusion changes the launch count, never the tokens
        fused_same = _streams(engine(decode_fusion=1).run_to_completion()) == dense
        say(f"bitwise-identical to decode_fusion=1: {fused_same}")
        for req in sorted(done, key=lambda r: r.uid):
            say(f"  req {req.uid}: prompt={[int(t) for t in req.prompt]} -> "
                f"generated={req.generated}")

        # --- paged KV cache: the same requests in the same KV memory ---------
        pled = OverheadLedger()
        paged = engine(batch_slots=8, decode_fusion=4, paged=True, page_size=24,
                       pool_pages=17, ledger=pled)
        paged_same = _streams(paged.run_to_completion()) == dense
        split = pled.memory_split()
        say(f"\npaged engine: bitwise-identical to dense: {paged_same}; sustained "
            f"concurrency {paged.concurrency_stats()['sustained']:.1f} (dense slots would "
            f"cap at 4)")
        say(f"paged memory split: peak reserved {split['peak_reserved_bytes']:.0f} B, peak "
            f"stranded {split['peak_stranded_bytes']:.0f} B (dense strands max_len - len per "
            f"request)")
        say(f"pages: {paged.allocator.stats()}")

        # --- overcommit and graceful preemption -------------------------------
        oled = OverheadLedger()
        over = engine(batch_slots=8, decode_fusion=4, paged=True, page_size=8, pool_pages=6,
                      admission=AdmissionPolicy(growth_reserve=0.5),
                      preemption=PreemptionPolicy(snapshot_threshold_tokens=16), ledger=oled)
        over_same = _streams(over.run_to_completion()) == dense
        oc = oled.overcommit_split()
        say(f"\novercommitted engine (growth_reserve=0.5, 5-page pool): bitwise-identical "
            f"through preemption: {over_same}")
        say(f"  preemptions={oc['preemptions']:.0f} (snapshot resumes "
            f"{oc['snapshot_resumes']:.0f}, re-prefill {oc['reprefill_resumes']:.0f}), pages "
            f"reclaimed {oc['pages_reclaimed']:.0f}, recompute tokens "
            f"{oc['recompute_tokens']:.0f}")

        # --- tiered KV pool: a budgeted host arena -----------------------------
        tled = OverheadLedger()
        tiered = engine(batch_slots=8, decode_fusion=4, paged=True, page_size=8, pool_pages=6,
                        admission=AdmissionPolicy(growth_reserve=0.5),
                        preemption=PreemptionPolicy(snapshot_threshold_tokens=4), ledger=tled,
                        host_budget_bytes=4096, spill=SpillPolicy(refill_lookahead=4))
        tiered_same = _streams(tiered.run_to_completion()) == dense
        sp = tled.spill_split()
        say(f"\ntiered engine (host_budget_bytes=4096): bitwise-identical through "
            f"spill/refill/demotion: {tiered_same}")
        say(f"  spills={sp['spills']:.0f} ({sp['spill_bytes']:.0f} B), refills="
            f"{sp['refills']:.0f}, demotions={sp['demotions']:.0f} (replay fallback "
            f"{sp['replay_fallback_tokens']:.0f} tokens), host peak {sp['host_peak_bytes']:.0f} "
            f"B of {sp['host_budget_bytes']:.0f} B budget")
    say("\nshared-agent ledger:")
    for line in ledger.table().splitlines():
        say(" ", line)
    checks = {"fused_equals_unfused": fused_same, "paged_equals_dense": paged_same,
              "overcommitted_equals_dense": over_same, "tiered_equals_dense": tiered_same,
              "conv_frames_equal_plain": conv_ok}
    if not all(checks.values()):
        raise AssertionError(f"serve_lm's checks failed: {checks}")
    return {"streams": dense, "frames": frames, "waves": step, "checks": checks,
            "preemptions": oc["preemptions"], "spills": sp["spills"]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--small", action="store_true", help="a narrower model (the tests')")
    ap.add_argument("--policy", default="cuda-strict",
                    help="dispatch policy of the model calls: reference, torch, cuda, cuda-strict")
    args = ap.parse_args(argv)
    run(args.device, args.small, policy=args.policy)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
