"""Where chunked prefill parts from whole-prompt prefill, op by op.

    PYTHONPATH=src python -m repro_torch.bench.chunk_localise [--chunks 128,64,16]
        [--prompt 600] [--layers 16] [--seed 0] [--out result.json]

Prefills one prompt of ``--prompt`` tokens (end-padded to its power-of-two
bucket, as the engine pads it) through ``DecoderLM.prefill`` once, and
through repeated ``DecoderLM.prefill_chunk`` calls at each chunk size, at
the full width of ``llama3.2-1b`` (``--layers`` of its 16) under the
``cuda-strict`` policy, weights from ``--seed``.  Every ``dispatch.op`` call
is recorded (the norms, the q, k, v and o projections, flash attention, the
MLP matmuls) and each chunk's outputs are compared bitwise with the same
rows of the whole prompt's, in call order: the first (layer, op) whose
prompt rows differ is printed for each chunk size, with every op that
differs, and the k/v cache rows of the prompt.  Then each op of layer 0 is
replayed alone on the whole prompt's own inputs cut to a chunk (a matmul or
norm on x's rows, flash attention on the chunk's queries against the keys
up to its end), which says which ops part by themselves.

Runs on the card by default; ``--device cpu --reduced`` rehearses it on the
CPU at a tiny size (where every wrapper runs its plain version).  Imports
no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.core import dispatch
from repro_torch.models import build_model, init_params

#: the ops of one dense layer, in call order (the tied unembed is a plain
#: product outside dispatch)
LAYER_OPS = ("ln1", "wq", "wk", "wv", "flash", "wo", "ln2", "wg", "wu", "wd")


@contextlib.contextmanager
def recording(calls: list):
    """Record every ``dispatch.op`` call as (name, args, kwargs, output)."""
    real = dispatch.op

    def op(name, *args, **kwargs):
        out = real(name, *args, **kwargs)
        calls.append((name, args, kwargs, out))
        return out

    dispatch.op = op
    try:
        yield
    finally:
        dispatch.op = real


def row_axis(name: str) -> int:
    """The axis of an op's output that runs over the prompt's rows."""
    return 2 if name == "flash_attention" else 1


def label(i: int, n_layers: int) -> str:
    layer, j = divmod(i, len(LAYER_OPS))
    return "ln_f" if layer == n_layers else f"layer {layer} {LAYER_OPS[j]}"


def localise(model, params, tokens: torch.Tensor, n: int, chunk: int) -> dict:
    """Whole-prompt against ``chunk``-row prefill of ``tokens`` [b] (the
    first ``n`` real): the ops whose real rows part, in call order, and the
    cache rows."""
    cfg, b = model.cfg, tokens.numel()
    whole: list = []
    with recording(whole):
        _, cache = model.prefill(params, {"tokens": tokens[None]}, cache_len=b)
    spec = model.cache_specs(1, b)
    staging = {key: torch.zeros(spec[key].shape, dtype=spec[key].dtype, device=tokens.device)
               for key in ("k", "v")}
    parted: dict[int, float] = {}
    for start in range(0, b, chunk):
        size = min(chunk, b - start)
        got: list = []
        with recording(got):
            model.prefill_chunk(params, tokens[None, start:start + size], staging, start=start)
        if len(got) != len(whole):
            raise AssertionError(f"{len(got)} ops in a chunk, {len(whole)} in the prompt")
        real = min(size, n - start)
        for i, ((name, _, _, out), (_, _, _, ref)) in enumerate(zip(got, whole)):
            if real <= 0:
                break
            ax = row_axis(name)
            a = out.narrow(ax, 0, real)
            w = ref.narrow(ax, start, real)
            if not torch.equal(a, w):
                d = float((a.double() - w.double()).abs().max())
                parted[i] = max(parted.get(i, 0.0), d)
    res = {"chunk": chunk, "ops": len(whole), "parted": len(parted),
           "first_parted": label(min(parted), cfg.num_layers) if parted else None,
           "first_parted_max_abs": parted[min(parted)] if parted else 0.0,
           "parted_ops": [label(i, cfg.num_layers) for i in sorted(parted)][:40]}
    for key in ("k", "v"):
        res[f"cache_{key}_rows_equal"] = bool(torch.equal(cache[key][:, :, :, :n],
                                                          staging[key][:, :, :, :n]))
    res["isolated_layer0"] = isolated(whole[:len(LAYER_OPS)], n, chunk)
    return res


def isolated(layer0: list, n: int, chunk: int) -> dict[str, bool]:
    """Each of layer 0's ops replayed on the whole prompt's inputs cut to
    every chunk: True where each chunk's rows are bitwise the whole call's."""
    out = {}
    for tag, (name, args, kwargs, ref) in zip(LAYER_OPS, layer0):
        same = True
        for start in range(0, n, chunk):
            real = min(chunk, n - start)
            if name == "flash_attention":
                q, k, v = args
                size = min(chunk, q.shape[2] - start)
                got = dispatch.op(name, q[:, :, start:start + size].contiguous(),
                                  k[:, :, :start + size].contiguous(),
                                  v[:, :, :start + size].contiguous(), **kwargs)
                got = got[:, :, :real]
            else:
                x, *rest = args
                got = dispatch.op(name, x[:, start:start + real], *rest, **kwargs)
            same = same and bool(torch.equal(got, ref.narrow(row_axis(name), start, real)))
        out[tag] = same
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", default="128,64,16")
    ap.add_argument("--prompt", type=int, default=600)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="a tiny llama (2 layers, d_model 64) for a CPU rehearsal")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chunk_localise: no CUDA device (--device cpu rehearses on the CPU)",
              file=sys.stderr)
        return 2
    cfg = get_arch("llama3.2-1b")
    cfg = (reduce_cfg(cfg, layers=2, d_model=64, vocab=128) if args.reduced
           else dataclasses.replace(cfg, num_layers=args.layers))
    model = build_model(cfg, device=args.device)
    params = init_params(model.param_specs(), args.seed, device=args.device)
    gen = torch.Generator().manual_seed(args.seed + 1)
    b = 8
    while b < args.prompt:
        b *= 2
    tokens = torch.zeros(b, dtype=torch.long)
    tokens[:args.prompt] = torch.randint(0, cfg.vocab_size, (args.prompt,), generator=gen)
    tokens = tokens.to(model.device)
    card = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
           if args.device == "cuda" else "")
    print(f"chunk_localise: {cfg.name}, {cfg.num_layers} layers, a {args.prompt}-token prompt "
          f"(bucket {b}), cuda-strict, on {card} ({smi})")
    results = []
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        for chunk in (int(c) for c in args.chunks.split(",")):
            res = localise(model, params, tokens, args.prompt, chunk)
            results.append(res)
            print(json.dumps(res), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "nvidia_smi": smi, "results": results},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
