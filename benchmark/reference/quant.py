"""The weight and cache roundings a served configuration states, worked
out in float32 from the raw weights: no value is taken from the program.

- int4 decoder projections: per output channel, symmetric, values in
  [-7, 7], scale = max |w| over the channel's inputs / 7;
- int8 lm_head: the same with 127;
- NF4 value rounding of the tower's dense projections: blocks of 64
  consecutive values of the [in, out] (flax) element order, each scaled by
  its largest magnitude onto the 16-value NF4 grid;
- the KV cache: per (token, head), symmetric, max |x| over the head's
  values / qmax (int8: 127; the control's int4: 7).
"""

from __future__ import annotations

import torch

NF4_GRID = (-1.0, -0.6961928009986877, -0.5250730514526367,
            -0.39491748809814453, -0.28444138169288635,
            -0.18477343022823334, -0.09105003625154495, 0.0,
            0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
            0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
            0.7229568362236023, 1.0)


def per_channel(w: torch.Tensor, qmax: int) -> torch.Tensor:
    """A Linear weight [out, in] rounded onto its per-output-channel
    symmetric grid of +-qmax steps, as float32 values."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=1, keepdim=True), min=1e-8) / qmax
    return torch.round(w / scale).clamp(-qmax, qmax) * scale


def nf4(w: torch.Tensor, block: int = 64) -> torch.Tensor:
    """A Linear weight [out, in] rounded onto the NF4 grid in blocks of
    `block` values of its transpose's row-major order, as float32."""
    wt = w.float().t().contiguous()
    flat = wt.reshape(-1)
    pad = (-flat.numel()) % block
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    absmax = torch.clamp(blocks.abs().amax(dim=1, keepdim=True), min=1e-12)
    grid = torch.tensor(NF4_GRID, dtype=torch.float32, device=w.device)
    out = torch.empty_like(blocks)
    for i in range(0, blocks.shape[0], 1 << 16):    # bounded temporaries
        b = blocks[i:i + (1 << 16)] / absmax[i:i + (1 << 16)]
        idx = torch.argmin((b[..., None] - grid).abs(), dim=-1)
        out[i:i + (1 << 16)] = grid[idx] * absmax[i:i + (1 << 16)]
    return out.reshape(-1)[:flat.numel()].reshape(wt.shape).t()


def kv_round(x: torch.Tensor, qmax: int) -> torch.Tensor:
    """x [..., head_dim] rounded per row onto +-qmax steps of its largest
    magnitude (the cache's quantize-dequantize), float32."""
    x = x.float()
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) / qmax
    return torch.round(x / scale).clamp(-qmax, qmax) * scale
