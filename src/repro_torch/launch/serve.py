"""Serving launcher: batched generation with the continuous-batching engine
(``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --reduced \\
      --requests 6 --max-new 16 [--device cpu]

Weights are drawn from a generator seeded 0, prompts from numpy's seeded 0,
as the JAX launcher's; the engine is one device's (the card's unless
``--device cpu``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.models import build_model
from repro_torch.models.params import init_params
from repro_torch.serve.engine import ServeEngine


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg, device=args.device)
    params = init_params(model.param_specs(), 0, device=model.device)
    engine = ServeEngine(model, params, batch_slots=args.slots, max_len=args.max_len,
                         temperature=args.temperature, device=model.device)

    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        plen = int(rng.integers(2, 10))
        prompt = rng.integers(1, cfg.vocab_size, plen).tolist()
        engine.submit(prompt, max_new_tokens=args.max_new)

    done = engine.run_to_completion()
    for req in sorted(done, key=lambda r: r.uid):
        print(f"req {req.uid}: prompt[{len(req.prompt)}] -> {req.generated}")
    print(f"[serve] completed {len(done)}/{args.requests} requests")
    return 0


if __name__ == "__main__":
    sys.exit(main())
