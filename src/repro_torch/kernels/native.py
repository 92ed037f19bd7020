"""Build, load and launch the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes`` — no PyTorch headers, so
a build takes seconds.  The first call that needs a library builds every
kernel that is not built yet, one ``nvcc`` per source, all started together.
Libraries land in ``build/repro_torch_kernels/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of their sources and flags, so an
edit to a source rebuilds only what changed.

Nothing here runs at import: the CPU tests import every module, and this
machine need not have ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("matmul", "rmsnorm", "flash_attention", "decode_attention", "ssd", "conv2d")
HEADERS = ("common.cuh", "hopper.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: streaming multiprocessors of the H100 SXM: the count the launch rules
#: (matmul's plan, flash attention's split) assume where no card is visible
H100_SMS = 132

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}
_logs: dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and under $CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built on this machine")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (f"{name}.cu", *HEADERS):
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, in parallel; the paths
    of all libraries.  Raises with the compiler's output if one fails."""
    targets = {name: _target(name) for name in SOURCES}
    todo = {n: p for n, p in targets.items() if not p.exists()}
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs: dict[str, tuple[subprocess.Popen, Path]] = {}
    try:
        for name, path in todo.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            _logs[name] = out
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{out}")
            else:
                os.replace(tmp, todo[name])   # atomic: concurrent builders agree
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return targets


def build_logs() -> dict[str, str]:
    """Compiler output (``-Xptxas -v``: registers, shared memory, spills) of
    the sources built by this process."""
    return dict(_logs)


def function(lib: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<lib>.cu``, built and loaded on
    first use.  Pointers must be declared ``c_void_p``: ctypes would pass a
    bare Python int as a 32-bit int and cut it."""
    key = f"{lib}:{symbol}"
    with _lock:
        fn = _fns.get(key)
        if fn is None:
            if lib not in _libs:
                _libs[lib] = ctypes.CDLL(str(build_all()[lib]))
            fn = getattr(_libs[lib], symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[key] = fn
    return fn


@functools.cache
def sm_count() -> int:
    """Streaming multiprocessors of the current card, read once; the H100's
    132 where no card is visible."""
    if not torch.cuda.is_available():
        return H100_SMS
    return torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU: the wrappers then run their
    plain version.  A mix of CPU and other devices is refused."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if "cpu" in kinds:
        raise ValueError(f"tensors on mixed devices: {sorted(str(t.device) for t in tensors)}")
    return False


def check(op: str, tensors: dict[str, torch.Tensor], dtype: torch.dtype | None = None, *,
          aligned: bool = True) -> None:
    """Refuse what the kernels do not take: tensors off one CUDA device, of
    another dtype, not contiguous, or (``aligned``) not 16-byte aligned."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{op}: the CUDA kernel needs all tensors on one CUDA device, "
                         f"got {sorted(str(d) for d in devices)}")
    for name, t in tensors.items():
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{op}: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
        if aligned and t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be 16-byte aligned")


# one counter buffer per (kernel, device, CUDA stream): a kernel that splits
# its work across blocks leaves its counters zeroed, and two streams never
# share one
_counters: dict[tuple[str, int, int], torch.Tensor] = {}


def tile_counters(op: str, device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for ``op``'s launches on
    ``stream`` (a ``cuda_stream`` handle)."""
    key = (op, device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def raise_on_error(op: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{op}: CUDA kernel launch failed with cudaError_t {err}")
