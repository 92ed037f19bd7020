"""Small-filter convolution written by hand for Hopper (``csrc/conv2d.cu``) —
paper Table I roles 3 and 4.

Replaces the Pallas TPU kernel ``repro/kernels/conv2d.py`` ``conv2d``
(``_conv_kernel``) and its weight-specialised factory
``conv2d_fixed_weight``: a VALID stride-1 convolution of NHWC ``x``
[B, H, W, Cin] with HWIO ``w`` [kh, kw, Cin, F]; int16 inputs accumulate in
int32 and return int32 (sums past 2^31 wrap, as XLA's int32 arithmetic
does), f32 inputs accumulate and return f32.

What bounds it on the H100: the paper's roles do 2·kh·kw·Cin·F operations a
pixel (50 for the 5x5 one-filter role) on 2-byte inputs, so bytes bound it
once the card is full; a single 64x64 frame is a few microseconds of launch
and one memory trip.  Hopper's tensor cores have no int16 product, so the
kernel runs on the CUDA cores: each thread computes a strip of ``P``
output pixels of a row, sliding the filter window through registers, with
the filter chunk sized to F (1, 2, 4 or 8) and, for the roles, the taps in
registers (a filter too large for one shared-memory slab beside the input
tile is staged through it in chunks of rows, :func:`filter_rows`, and one
so tall that the input tile alone passes the shared memory stages the
input rows with each slab, :func:`slab_rows`, the sums carried across the
slabs in the same order); persistent blocks walk (frame, tile, filter
chunk) work items,
staging the next item's input rows with a two-slot ``cp.async`` ring, so
any number of frames is one launch.  The fixed-weight role holds its filter
on the card from load to unload and launches the same kernel, so it is
bitwise equal to :func:`conv2d` on the same input.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.registry import ResourceFootprint
from repro_torch.kernels import native

ROUTE = "cuda"
SOURCE = "src/repro_torch/csrc/conv2d.cu"
REPLACES = "src/repro/kernels/conv2d.py:39"

#: launches of the CUDA kernel, through :func:`conv2d` or a fixed-weight role
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 7
             + [ctypes.c_void_p])
# the kernel's tile (csrc/conv2d.cu): 256 threads, a strip of 4 output pixels
# each, 16 strips across and 16 rows down; the channels of a staged chunk
# fill at most 48 KB, and one channel may take up to 227 KB
_THREADS, _TC, _TY = 256, 64, 16
_SMEM_SMALL, _SMEM_MAX = 48 * 1024, 227 * 1024


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """int32 for integer inputs, f32 otherwise (the Pallas kernel's rule)."""
    return torch.float32 if dtype.is_floating_point else torch.int32


def plain_conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the kh·kw taps as shifted
    elementwise products summed over Cin, in int32 (wrapping, as torch's
    int32 arithmetic does) or f32.  It needs no integer ``matmul`` or
    ``F.conv2d`` (the card has neither for int32)."""
    B, H, W, Cin = x.shape
    kh, kw, Cin2, F = w.shape
    if Cin != Cin2:
        raise ValueError(f"conv2d: x has {Cin} channels, w {Cin2}")
    acc_t = accum_dtype(x.dtype)
    xa, wa = x.to(acc_t), w.to(acc_t)
    oh, ow = H - kh + 1, W - kw + 1
    acc = torch.zeros((B, oh, ow, F), dtype=acc_t, device=x.device)
    for di in range(kh):
        for dj in range(kw):
            patch = xa[:, di:di + oh, dj:dj + ow, :]           # [B, oh, ow, Cin]
            for c in range(Cin):
                acc += patch[..., c:c + 1] * wa[di, dj, c]       # [B, oh, ow, F]
    return acc


def _filter_chunk(F: int) -> int:
    """Filters a chunk: 1, 2, 4 or 8, the least that holds F (8 above)."""
    return next(c for c in (1, 2, 4, 8) if F <= c or c == 8)


def _smem(cin: int, kh: int, kw: int, f: int, itemsize: int) -> tuple[int, int]:
    """(channels a staged chunk, shared-memory bytes of a block), as the
    kernel computes them: two ring slots of the input tile with its halo in
    the input's type, rows padded to 16 bytes, and the filter slab in 4-byte
    words.  A filter whose one-channel slab would pass 227 KB beside the ring
    is staged in slabs of the most filter rows that fit
    (:func:`filter_rows`); where not even one row fits, the input rows go in
    slabs too, one slot (:func:`slab_rows`); 0 channels when not even that
    fits."""
    khc = filter_rows(kh, kw, f, itemsize)
    if khc < 1:
        rows = slab_rows(kh, kw, f, itemsize)
        return (1 if rows else 0), _slab_bytes(max(rows, 1), kw, f, itemsize)
    if khc < kh:
        return 1, _block_bytes(1, khc, kh, kw, f, itemsize)
    cc = min(cin, max(1, _SMEM_SMALL // _block_bytes(1, kh, kh, kw, f, itemsize)))
    while cc > 1 and _block_bytes(cc, kh, kh, kw, f, itemsize) > _SMEM_SMALL:
        cc -= 1
    return cc, _block_bytes(cc, kh, kh, kw, f, itemsize)


def _block_bytes(cc: int, khc: int, kh: int, kw: int, f: int, itemsize: int) -> int:
    """A block's shared memory at ``cc`` channels a chunk and a filter slab
    of ``khc`` rows."""
    def r16(n: int) -> int:
        return -(-n // 16) * 16

    return (2 * (_TY + kh - 1) * r16((_TC + kw - 1) * cc * itemsize)
            + r16(khc * kw * cc * _filter_chunk(f) * 4))


def filter_rows(kh: int, kw: int, f: int, itemsize: int) -> int:
    """Filter rows a slab holds at one channel: ``kh`` where the whole
    filter fits beside the ring, else the most that do (0: none)."""
    khc = kh
    while khc > 0 and _block_bytes(1, khc, kh, kw, f, itemsize) > _SMEM_MAX:
        khc -= 1
    return khc


def _slab_bytes(khc: int, kw: int, f: int, itemsize: int) -> int:
    """A block's shared memory where the input rows go in slabs: one slot of
    the ``_TY + khc - 1`` input rows a slab of ``khc`` filter rows reads, and
    that slab, at one channel."""
    def r16(n: int) -> int:
        return -(-n // 16) * 16

    return ((_TY + khc - 1) * r16((_TC + kw - 1) * itemsize)
            + r16(khc * kw * _filter_chunk(f) * 4))


def slab_rows(kh: int, kw: int, f: int, itemsize: int) -> int:
    """Filter rows a slab holds where not one fits beside the ring (the input
    rows then staged with each slab): the most that fit with their
    ``_TY + khc - 1`` input rows (0: none; 0 too where one fits beside the
    ring, and this mode is not taken)."""
    if filter_rows(kh, kw, f, itemsize) > 0:
        return 0
    khc = kh
    while khc > 0 and _slab_bytes(khc, kw, f, itemsize) > _SMEM_MAX:
        khc -= 1
    return khc


def conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID stride-1 conv ``x [B,H,W,Cin]`` (*) ``w [kh,kw,Cin,F]``: the plain
    version for CPU tensors, else the CUDA kernel (int16 or f32 inputs of one
    type)."""
    if native.on_cpu(x, w):
        return plain_conv2d(x, w)
    if x.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"conv2d: the CUDA kernel takes int16 or f32, got {x.dtype}")
    native.check("conv2d", {"x": x, "w": w}, x.dtype, aligned=False)
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv2d: x must be [B,H,W,Cin] and w [kh,kw,Cin,F], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, H, W, Cin = x.shape
    kh, kw, Cin2, F = w.shape
    if Cin != Cin2:
        raise ValueError(f"conv2d: x has {Cin} channels, w {Cin2}")
    if H < kh or W < kw:
        raise ValueError(f"conv2d: a {kh}x{kw} filter does not fit a {H}x{W} image")
    if _smem(Cin, kh, kw, F, x.element_size())[0] < 1:
        raise ValueError(f"conv2d: the kernel takes filters whose 16 output rows' input and "
                         f"one filter row fit its shared memory, got {kh}x{kw}")
    out = torch.empty((B, H - kh + 1, W - kw + 1, F), dtype=accum_dtype(x.dtype),
                      device=x.device)
    if B == 0:
        return out
    fn = native.function("conv2d", "repro_conv2d", _ARGTYPES)
    err = fn(native.ptr(x), native.ptr(w), native.ptr(out), B, H, W, Cin, kh, kw, F,
             int(x.dtype == torch.float32), native.stream(x.device))
    native.raise_on_error("conv2d", err)
    native.count_launch(__name__)
    return out


class FixedWeightConv2d:
    """A conv role with its filter fixed: a callable of ``x`` alone, named as
    the JAX package names it.  :meth:`bind` puts the filter on a device
    (uploaded once, held until the bound role is dropped)."""

    def __init__(self, w: torch.Tensor) -> None:
        self.weight = w
        self.__name__ = f"conv2d_fixed_{w.shape[0]}x{w.shape[1]}x{w.shape[3]}"

    def bind(self, device: "str | torch.device") -> "FixedWeightConv2d":
        return FixedWeightConv2d(self.weight.to(device))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight)


def conv2d_fixed_weight(w: torch.Tensor) -> FixedWeightConv2d:
    """Weight-specialized conv role (paper roles 3/4: 'fixed weights')."""
    return FixedWeightConv2d(w)


def footprint(cin: int = 1, kh: int = 3, kw: int = 3, f: int = 2,
              itemsize: int = 2) -> ResourceFootprint:
    """Shared memory and threads of one block: the two-slot ring of the
    input tile with its halo, in the input's type, and the filter slab in
    4-byte words (defaults: paper role 4, 3x3x1x2 int16)."""
    return ResourceFootprint(smem_bytes=_smem(cin, kh, kw, f, itemsize)[1], threads=_THREADS)
