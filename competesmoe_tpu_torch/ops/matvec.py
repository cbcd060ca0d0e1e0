"""Small-M matmuls for decode (port of competesmoe_tpu/ops/matvec.py).

Three weight streams, each with float32 accumulation:

* K3 `small_m_matmul`: bf16 [M, K] x bf16 [K, N] -> [M, N];
* K4 `quant_small_m_matmul`: bf16 [M, K] x int8 [K, N] * scale[N], the
  per-output scale in a float32 epilogue;
* K5 `quant_small_m_matmul_int4`: [M, K] x nibble-packed int4
  [K//2, N] * scale[N]: `x[:, :K/2] @ lo + x[:, K/2:] @ hi` with
  sign-extended nibbles.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel (K3
and K4 in `csrc/matvec_small_m.cu`, K5 in `csrc/matvec_int4.cu`; built
with nvcc at first use by `_kernels.py`, bound with ctypes) or raises on
what the kernel does not take; on a CPU tensor it runs its plain PyTorch
version (`*_reference`). Each wrapper counts its kernel launches in
`.launches`.

The viability rules (`MAX_SMALL_M`, `MAX_QUANT_M`, `_BLOCK_K`, `_BLOCK_N`,
`_m_ok`, `small_m_viable`, `small_m_viable_int4`) are kept exactly as in
JAX, so the same shapes reach the kernels in both packages.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _kernels

MAX_SMALL_M = 32
MAX_QUANT_M = 128
_BLOCK_K = (512, 1024, 256, 128)
_BLOCK_N = (1024, 512, 256, 128)


def _pick(block_options, dim):
    for b in block_options:
        if dim % b == 0:
            return b
    return None


def _m_ok(m: int, cap: int) -> bool:
    return m <= min(MAX_SMALL_M, cap) or (m % 8 == 0 and m <= cap)


def small_m_viable(m: int, k: int, n: int,
                   max_m: int = MAX_SMALL_M) -> bool:
    """Shapes K3 (default cap 32) and K4 (`max_m=MAX_QUANT_M`) take."""
    return (_m_ok(m, max_m)
            and _pick(_BLOCK_K, k) is not None
            and _pick(_BLOCK_N, n) is not None)


def small_m_viable_int4(m: int, k: int, n: int) -> bool:
    """Shapes the packed-int4 kernel takes: M <= 32, or a multiple of 8 up
    to 128; the packed rows k//2 and the columns n tile the TPU kernel's
    blocks."""
    return (_m_ok(m, MAX_QUANT_M) and k % 2 == 0
            and _pick(_BLOCK_K, k // 2) is not None
            and _pick(_BLOCK_N, n) is not None)


def unpack_int4_halves(p: torch.Tensor):
    """int8 [K//2, N] -> (low, high) sign-extended int8 [K//2, N]: low =
    original rows [0, K/2), high = rows [K/2, K)."""
    p32 = p.to(torch.int32)
    lo = ((p32 & 0xF) ^ 8) - 8
    hi = p32 >> 4
    return lo.to(torch.int8), hi.to(torch.int8)


def small_m_matmul_reference(x: torch.Tensor,
                             w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: float32 product, cast to x.dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def quant_small_m_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                                   scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: float32 product with the int8 values,
    the scale applied in a float32 epilogue, cast to x.dtype."""
    return ((x.float() @ w_q.float()) * scale.float()[None, :]).to(x.dtype)


def quant_small_m_matmul_int4_reference(x: torch.Tensor,
                                        w_packed: torch.Tensor,
                                        scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel's arithmetic: sign-extend the
    nibbles, contract each half against its x slice with float32
    accumulation, multiply by the scale in float32, cast to x.dtype."""
    half = w_packed.shape[0]
    lo, hi = unpack_int4_halves(w_packed)
    acc = (x[:, :half].float() @ lo.float()
           + x[:, half:].float() @ hi.float())
    return (acc * scale.float()[None, :]).to(x.dtype)


# ---------------------------------------------------------------------------
# Bind the CUDA kernels (built by competesmoe_tpu_torch/_kernels.py)
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qmm4_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.qmm4_launch.restype = ctypes.c_int


def _bind_small_m(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mm_bf16_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.mm_bf16_launch.restype = ctypes.c_int
    lib.qmm8_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.qmm8_launch.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# geometry of the kernels: (outputs per block, K per stage of the block's
# ring, blocks an SM the splits aim for) of K3 and K4
# (csrc/matvec_small_m.cu) and K5 (csrc/matvec_int4.cu; its K is the
# packed rows); the K splits of a block are one cluster. K4 and K5 fit two
# or three blocks an SM and are faster with half again as many blocks as
# SMs (PERF.md)
_K3_GEOMETRY = (64, 128, 1.0)
_K4_GEOMETRY = (128, 64, 1.5)
_K5_GEOMETRY = (128, 64, 1.5)
_MAX_SPLITS = 8


def _check_x(x: torch.Tensor, *others: torch.Tensor) -> None:
    if x.device.type != "cuda" or any(t.device != x.device for t in others):
        raise ValueError("the operands must share one CUDA device")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"expected bf16 x, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or not x.is_contiguous() \
            or x.data_ptr() % 16 or x.shape[1] % 8:
        raise ValueError(f"x must be a contiguous [M, K] with K % 8 == 0 "
                         f"and 16-byte aligned; got {tuple(x.shape)} "
                         f"strides {x.stride()}")


def _cluster_splits(k: int, n: int, n_sms: int, geometry):
    """(splits, chunk) of K3, K4 or K5 (`geometry`: outputs per block, K
    per stage, blocks an SM; K5's K is its packed rows): the blocks that
    share a block of outputs split K and form one thread-block cluster,
    which reduces their sums inside the launch. Double the splits (at
    most 8, the portable cluster size) until the blocks cover every SM
    `fill` times, keeping at least two stages per split; each split is a
    whole number of stages and the last one is not empty. Every row of x
    goes through one block in one pass, so the rule does not depend on
    M."""
    block_out, stage_k, fill = geometry
    blocks = -(-n // block_out)
    splits = 1
    while (splits < _MAX_SPLITS and blocks * splits < fill * n_sms
           and k >= 4 * splits * stage_k):
        splits *= 2
    chunk = -(-k // splits)
    chunk = -(-chunk // stage_k) * stage_k
    return -(-k // chunk), chunk


def quant_small_m_matmul_int4(x: torch.Tensor, w_packed: torch.Tensor,
                              scale: torch.Tensor) -> torch.Tensor:
    """K5: [M, K] bf16 x nibble-packed int4 [K//2, N] * scale f32 [N] ->
    [M, N] bf16, float32 accumulation, the scale applied once per output
    in a float32 epilogue. CUDA tensors launch the Hopper kernel, one
    launch for any M up to MAX_QUANT_M (raising on anything it does not
    take); CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return quant_small_m_matmul_int4_reference(x, w_packed, scale)
    _check_x(x, w_packed, scale)
    if w_packed.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"expected int8 w_packed and f32 scale; got "
                        f"{w_packed.dtype}, {scale.dtype}")
    m, k = x.shape
    if w_packed.dim() != 2 or scale.dim() != 1 \
            or k != 2 * w_packed.shape[0] or k % 16 \
            or scale.shape[0] != w_packed.shape[1] or w_packed.shape[1] % 16:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, w_packed "
                         f"{tuple(w_packed.shape)}, scale {tuple(scale.shape)}"
                         f" (K % 16 == 0 and N % 16 == 0)")
    k2, n = w_packed.shape
    if not (w_packed.is_contiguous() and scale.is_contiguous()) \
            or w_packed.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("w_packed and scale must be contiguous and 16-byte "
                         "aligned")
    if m > MAX_QUANT_M:
        raise ValueError(f"K5 takes at most {MAX_QUANT_M} rows of x; got {m}")
    lib = _kernels.load("matvec_int4", _bind)
    splits, chunk = _cluster_splits(k2, n, _sm_count(x.device.index),
                                    _K5_GEOMETRY)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = lib.qmm4_launch(
        x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        m, k2, n, splits, chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(rc, "int4 small-M matmul")
    quant_small_m_matmul_int4.launches += 1
    return out


def small_m_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K3: bf16 [M, K] x bf16 [K, N] -> [M, N] bf16, float32 accumulation.

    `w` keeps JAX's [K, N] shape. On the card it must be the transposed
    view of a contiguous [N, K] matrix (strides (1, K), as
    `nn.Linear.weight.t()` gives): the kernel reads each output's K
    contiguous values in place. Any other layout raises; a transposed copy
    per call would double the bytes the kernel exists to save. CPU
    tensors run the plain version."""
    if x.device.type == "cpu":
        return small_m_matmul_reference(x, w)
    _check_x(x, w)
    if w.dtype != torch.bfloat16:
        raise TypeError(f"expected bf16 w, got {w.dtype}")
    m, k = x.shape
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    n = w.shape[1]
    if w.stride() != (1, k) or w.data_ptr() % 16:
        raise ValueError(f"w must be the [K, N] view of a contiguous [N, K] "
                         f"matrix (strides (1, {k}), 16-byte aligned); got "
                         f"strides {w.stride()}")
    if m > MAX_SMALL_M:
        raise ValueError(f"K3 takes at most {MAX_SMALL_M} rows of x; got {m}")
    lib = _kernels.load("matvec_small_m", _bind_small_m)
    splits, chunk = _cluster_splits(k, n, _sm_count(x.device.index),
                                    _K3_GEOMETRY)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = lib.mm_bf16_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, splits, chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(rc, "bf16 small-M matmul")
    small_m_matmul.launches += 1
    return out


def quant_small_m_matmul(x: torch.Tensor, w_q: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """K4: bf16 [M, K] x int8 [K, N] * scale f32 [N] -> [M, N] bf16, the
    scale applied once per output in a float32 epilogue. CUDA tensors
    launch the Hopper kernel, one launch for any M up to MAX_QUANT_M
    (raising on anything it does not take); CPU tensors run the plain
    version."""
    if x.device.type == "cpu":
        return quant_small_m_matmul_reference(x, w_q, scale)
    _check_x(x, w_q, scale)
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"expected int8 w_q and f32 scale; got {w_q.dtype}, "
                        f"{scale.dtype}")
    m, k = x.shape
    if w_q.dim() != 2 or scale.dim() != 1 or w_q.shape[0] != k \
            or scale.shape[0] != w_q.shape[1] or w_q.shape[1] % 16:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, scale {tuple(scale.shape)}")
    n = w_q.shape[1]
    if not (w_q.is_contiguous() and scale.is_contiguous()) \
            or w_q.data_ptr() % 16:
        raise ValueError("w_q and scale must be contiguous and w_q 16-byte "
                         "aligned")
    if m > MAX_QUANT_M:
        raise ValueError(f"K4 takes at most {MAX_QUANT_M} rows of x; got {m}")
    lib = _kernels.load("matvec_small_m", _bind_small_m)
    splits, chunk = _cluster_splits(k, n, _sm_count(x.device.index),
                                    _K4_GEOMETRY)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = lib.qmm8_launch(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k,
        n, splits, chunk, torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(rc, "int8 small-M matmul")
    quant_small_m_matmul.launches += 1
    return out


quant_small_m_matmul_int4.launches = 0
small_m_matmul.launches = 0
quant_small_m_matmul.launches = 0
