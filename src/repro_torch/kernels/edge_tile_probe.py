"""Where the edge tile kernel's time goes, on one CUDA card:

    PYTHONPATH=src python -m repro_torch.kernels.edge_tile_probe [--out probe.json]

Builds a copy of ``csrc/matmul.cu`` under ``build/edge_tile_probe/`` with
``%globaltimer`` stamps in ``mm_edge_tile_kernel`` and runs it at hymba's
in_proj ``[M,1600]x[1600,6482]`` (M = 17 and 1400) and whisper's unembed
``[64,1280]x[1280,51866]``, bf16 out, after 30 launches back to back.  It
prints, per block (thread 0 of the products), the median time from the
block's start to the end of its products, the f32 staging and the
stores; and for block (0, 0) each K slice's moments: when its w boxes and
x box were issued, when w landed (seen by a realigner), when the slice's
B tile was realigned, and when the products found A and B ready.  The
stamps cost a few instructions a slice; times are device nanoseconds.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import matmul as mm
from repro_torch.kernels import native

SHAPES = ((17, 1600, 6482), (1400, 1600, 6482), (64, 1280, 51866))
#: per-slice stamps of block (0, 0): the copy warp's w issue, the x issue,
#: w landed, the slice realigned, A ready and B ready at the products
SLICE_EVENTS = ("w_issued", "x_issued", "w_landed", "realigned", "a_ready", "b_ready")
#: per-block stamps: the start, the products' end, the staged tile, the stores' end
BLOCK_EVENTS = ("start", "products", "staged", "stored")
MAX_BLOCKS, MAX_SLICES = 8192, 64


def _stamp(array: str, index: str, cond: str) -> str:
    return ('{ unsigned long long tt; asm volatile("mov.u64 %0, %globaltimer;" : "=l"(tt)); '
            f'if ({cond}) {array}[{index}] = tt; }}')


def patched_source() -> str:
    """``csrc/matmul.cu`` with the stamps in the edge tile kernel: every
    block (up to MAX_BLOCKS), and the first MAX_SLICES slices of block
    (0, 0)."""
    src = (native.CSRC / "matmul.cu").read_text()
    head = src.rfind("template <int BN>", 0, src.index("mm_edge_tile_kernel(const __grid_constant__"))
    src = (src[:head]
           + f"__device__ unsigned long long probe_slice[{len(SLICE_EVENTS) * MAX_SLICES}];\n"
           f"__device__ unsigned long long probe_block[{len(BLOCK_EVENTS) * MAX_BLOCKS}];\n"
           + src[head:])
    head = src.index("mm_edge_tile_kernel(const __grid_constant__")
    first = f"blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && i < {MAX_SLICES}"
    tile = "(blockIdx.y * gridDim.x + blockIdx.x)"
    block = f"threadIdx.x == 0 && {tile} < {MAX_BLOCKS}"
    slot = lambda e: f"{tile} * {len(BLOCK_EVENTS)} + {e}"  # noqa: E731
    slice_at = lambda e: f"{e} * {MAX_SLICES} + i"  # noqa: E731

    def put(anchor: str, text: str, after: bool, start: int = 0) -> None:
        """``text`` on a line of its own before or after the line holding
        ``anchor`` (the first in the kernel at or after ``start``)."""
        nonlocal src
        j = src.index(anchor, max(head, start))
        j = src.index("\n", j) + 1 if after else src.rfind("\n", 0, j) + 1
        src = src[:j] + text + "\n" + src[j:]

    put("mbar_expect_tx(raw_full + rs, C::RAW_W);", _stamp("probe_slice", slice_at(0), first),
        after=False)
    put("mbar_expect_tx(a_full + as, half ? C::A_BYTES / 2 : C::A_BYTES);",
        _stamp("probe_slice", slice_at(1), first), after=False)
    realign = src.index("if (threadIdx.x >= 320) {  // realign", head)
    put("mbar_wait(raw_full + rs, (i / RS) & 1);",
        _stamp("probe_slice", slice_at(2), first + " && t == 0"), after=True, start=realign)
    put("mbar_arrive(b_full + bs);", _stamp("probe_slice", slice_at(3), first + " && t == 0"),
        after=False, start=realign)
    busy = src.index("for (int i = 0; i < nk && !idle; ++i) {", head)
    put("mbar_wait(a_full + i % AS, (i / AS) & 1);",
        _stamp("probe_slice", slice_at(4), first + " && threadIdx.x == 0"), after=True,
        start=busy)
    put("const uint64_t da = wgmma_desc(smem + (i % AS)",
        _stamp("probe_slice", slice_at(5), first + " && threadIdx.x == 0"), after=False,
        start=busy)
    put("grid_dependency_wait();  // the previous kernel", _stamp("probe_block", slot(0), block),
        after=False)
    put("bar_sync_first<256>();  // every product has read the rings",
        _stamp("probe_block", slot(1), block), after=True)
    put("const int tile = blockIdx.y * gridDim.x + blockIdx.x;",
        _stamp("probe_block", slot(2), block), after=False)
    end = src.index("}\n\n// ---- host side of the bf16 path", head)
    src = (src[:end] + "  bar_sync_first<256>();\n" + _stamp("probe_block", slot(3), block)
           + "\n" + src[end:])
    return src + ('\nextern "C" int probe_read(void* slices, void* blocks) {\n'
                  "  cudaError_t e = cudaMemcpyFromSymbol(slices, probe_slice, sizeof(probe_slice));\n"
                  "  return (int)(e != cudaSuccess ? e : cudaMemcpyFromSymbol(blocks, probe_block,"
                  " sizeof(probe_block)));\n}\n")


def build() -> ctypes.CDLL:
    out = Path(native.BUILD_DIR).parent / "edge_tile_probe"
    out.mkdir(parents=True, exist_ok=True)
    for h in native.HEADERS:
        shutil.copy(native.CSRC / h, out / h)
    (out / "matmul.cu").write_text(patched_source())
    r = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-o", str(out / "libmatmul.so"),
                        str(out / "matmul.cu")], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout[-4000:]}{r.stderr[-4000:]}")
    lib = ctypes.CDLL(str(out / "libmatmul.so"))
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def probe(lib: ctypes.CDLL, M: int, K: int, N: int, gen: torch.Generator) -> dict:
    dev = torch.device("cuda")
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
    kernel, _ = mm.edge_plan(M, N, K, True)
    if kernel not in mm.EDGE_TILE_BN:
        raise ValueError(f"[{M},{K}]x[{K},{N}] does not run the edge tile kernel")
    for _ in range(30):
        mm.matmul(x, w)
    torch.cuda.synchronize()
    slices = np.zeros(len(SLICE_EVENTS) * MAX_SLICES, dtype=np.uint64)
    blocks = np.zeros(len(BLOCK_EVENTS) * MAX_BLOCKS, dtype=np.uint64)
    if lib.probe_read(slices.ctypes.data, blocks.ctypes.data):
        raise RuntimeError("reading the stamps failed")
    tiles = -(-M // mm.EDGE_TILE_BM) * -(-N // mm.EDGE_TILE_BN[kernel])
    b = blocks[:tiles * len(BLOCK_EVENTS)].reshape(tiles, -1).astype(np.int64)
    nk = -(-K // mm.BK)
    s = slices.reshape(len(SLICE_EVENTS), MAX_SLICES)[:, :nk].astype(np.int64)
    return {"shape": [M, K, N], "instance": mm.kernel_instance(x, w), "tiles": tiles,
            "block_median_us": {e: float(np.median(b[:, i] - b[:, i - 1])) / 1e3
                                for i, e in enumerate(BLOCK_EVENTS) if i},
            "slices_ns_from_first_w_issue": {e: (s[i] - s[0, 0]).tolist()
                                             for i, e in enumerate(SLICE_EVENTS)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("edge_tile_probe: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({smi})")
    lib = build()
    native._libs["matmul"] = lib   # the wrapper's launches go to the stamped copy
    native._fns.clear()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for M, K, N in SHAPES:
        row = probe(lib, M, K, N, gen)
        rows.append(row)
        print(f"[{M},{K}]x[{K},{N}] {row['instance']}, {row['tiles']} tiles, block medians (us): "
              + ", ".join(f"{e} {v:.2f}" for e, v in row["block_median_us"].items()))
        for e, ts in row["slices_ns_from_first_w_issue"].items():
            print(f"  {e:10s} " + " ".join(f"{t:6d}" for t in ts))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                                        "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
