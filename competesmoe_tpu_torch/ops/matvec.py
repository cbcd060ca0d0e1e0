"""Packed-int4 small-M matmul for decode (port of the K5 path of
competesmoe_tpu/ops/matvec.py).

`quant_small_m_matmul_int4` computes [M, K] x nibble-packed int4
[K//2, N] * scale[N] -> [M, N]: `x[:, :K/2] @ lo + x[:, K/2:] @ hi` with
sign-extended nibbles, float32 accumulation and the per-output scale in
the epilogue. On a CUDA tensor it launches the hand-written Hopper kernel
in `csrc/matvec_int4.cu` (built with nvcc at first use by `_kernels.py`,
bound with ctypes); on a CPU tensor it runs
`quant_small_m_matmul_int4_reference`, the plain PyTorch version of the
same arithmetic.

The viability rules (`MAX_QUANT_M`, `_BLOCK_K`, `_BLOCK_N`, `_m_ok`,
`small_m_viable_int4`) are kept exactly as in JAX, so the same shapes
reach the kernel in both packages.
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
# Bind the CUDA kernel (built by competesmoe_tpu_torch/_kernels.py)
# ---------------------------------------------------------------------------

# K-split geometry of csrc/matvec_int4.cu
_KERNEL_BLOCK_N = 256
_KERNEL_ROW_STEP = 16          # K-lanes * unroll
_KERNEL_MAX_CHUNK = 256


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qmm4_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.qmm4_launch.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _split_k(k2: int, n: int, n_sms: int):
    """(splits, chunk): cut the packed K rows across blocks so that about
    four blocks per SM are in flight, with at least 64 rows per split and
    at most the kernel's 256-row staging buffer."""
    blocks_n = -(-n // _KERNEL_BLOCK_N)
    splits = max(1, min(-(-4 * n_sms // blocks_n), k2 // 64))
    chunk = -(-k2 // splits)
    chunk = -(-chunk // _KERNEL_ROW_STEP) * _KERNEL_ROW_STEP
    chunk = min(chunk, _KERNEL_MAX_CHUNK)
    return -(-k2 // chunk), chunk


def quant_small_m_matmul_int4(x: torch.Tensor, w_packed: torch.Tensor,
                              scale: torch.Tensor) -> torch.Tensor:
    """[M, K] bf16 x nibble-packed int4 [K//2, N] * scale f32 [N] -> [M, N]
    bf16. CUDA tensors launch the Hopper kernel (raising on anything it
    does not take); CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return quant_small_m_matmul_int4_reference(x, w_packed, scale)
    if x.device.type != "cuda" or w_packed.device != x.device \
            or scale.device != x.device:
        raise ValueError("x, w_packed and scale must share one CUDA device")
    if (x.dtype != torch.bfloat16 or w_packed.dtype != torch.int8
            or scale.dtype != torch.float32):
        raise TypeError(f"expected bf16 x, int8 w_packed, f32 scale; got "
                        f"{x.dtype}, {w_packed.dtype}, {scale.dtype}")
    if x.dim() != 2 or w_packed.dim() != 2 or scale.dim() != 1:
        raise ValueError("expected x [M, K], w_packed [K/2, N], scale [N]")
    m, k = x.shape
    k2, n = w_packed.shape
    if k != 2 * k2 or scale.shape[0] != n or n % 8 or m < 1:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, w_packed "
                         f"{tuple(w_packed.shape)}, scale {tuple(scale.shape)}")
    if not (x.is_contiguous() and w_packed.is_contiguous()
            and scale.is_contiguous()) or w_packed.data_ptr() % 16:
        raise ValueError("x, w_packed and scale must be contiguous and "
                         "w_packed 16-byte aligned")
    lib = _kernels.load("matvec_int4", _bind)
    splits, chunk = _split_k(k2, n, _sm_count(x.device.index))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    rc = lib.qmm4_launch(
        x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        out.data_ptr(), m, k2, n, splits, chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(rc, "int4 matvec")
    quant_small_m_matmul_int4.launches += 1
    return out


quant_small_m_matmul_int4.launches = 0
