"""K5's share of its roofline over the traced window: the least time the
window's int4 decode projections need, counted from the layer's shapes,
over the device time of the kernels named below.

Which forwards ran K5 comes from the port's own count: each decoder
forward in the window is logged with its rows M (batch x tokens) and the
launches that `ops.matvec.quant_small_m_matmul_int4` counted in it,
replays of a captured step included (`harness.trace.ForwardLog`). Each
forward that launched K5 needs, for every layer, its four projections
once: the packed int4 weights (K x N / 2 bytes) and float32 scales (4 N
bytes) read once, the bf16 input (2 M K) read once, the bf16 output (2 M
N) written once, and 2 M K N operations; the least time is the larger of
bytes at the memory peak and operations at the bf16 peak, summed over
those forwards. That work does not depend on how many launches the
program spends on it.

The kernel's device records have to match the launches the wrappers
counted: the profiler can miss the window's first or last forward, so
they may differ by the launches of those two forwards and no more. A
window whose forwards launched K5 and whose trace holds no record named
below, or another count, is an error, not a reading.
"""

from harness.peaks import bound_s

LAYER = "int4 decode projections (ops/matvec.py K5, csrc/matvec_int4.cu)"
MOVES = "serve_tok_s"
KERNELS = ("qmm4_kernel",)
WRAPPER = "quant_small_m_matmul_int4"


def projections(g):
    """(K, N) of one decoder layer's four projections."""
    kvd = g.kv_heads * g.head_dim
    return [(g.d, g.d + 2 * kvd), (g.d, g.d), (g.d, 2 * g.ffn),
            (g.ffn, g.d)]


def launch_work(m: int, k: int, n: int):
    """(bytes, operations) of one projection at M rows."""
    return k * n // 2 + 4 * n + 2 * m * k + 2 * m * n, 2 * m * k * n


def forward_bound_s(g, m: int) -> float:
    """The least time one forward's int4 projections need at M rows."""
    return g.layers * sum(bound_s(*launch_work(m, k, n))
                          for k, n in projections(g))


def read(run):
    s = run.served
    if s.trace is None:
        return None
    fwd = [(b * t, n[WRAPPER]) for (b, t), n in s.decoder_rows
           if n.get(WRAPPER)]
    if not fwd:
        return None
    launches = sum(n for _, n in fwd)
    count, seconds = s.trace.kernel_time(KERNELS)
    if abs(count - launches) > fwd[0][1] + fwd[-1][1]:
        raise RuntimeError(
            f"{launches} K5 launches counted by {WRAPPER} in the window's "
            f"{len(fwd)} forwards and {count} device records named "
            f"{KERNELS}")
    return 100.0 * sum(forward_bound_s(run.geometry, m)
                       for m, _ in fwd) / seconds
