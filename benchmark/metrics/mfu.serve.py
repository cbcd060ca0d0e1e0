"""The whole window's share of the card's roofline in a serving cell:
the least time the work served in the traced window needs, over the
window. That least time is the larger of the window's operations at the
bf16 tensor-core peak and its bytes at the memory peak.

Counted from the configuration's shapes, not from kernels:
- operations: for each token that reached a client in the window, the
  decoder's four projections (2 K N a token and layer) and the lm_head
  (2 d V) for the position that made it, and attention over the keys it
  saw (4 d a key and layer); for a first token also the rest of its
  prompt (projections, causal attention) and, for an image, the tower's
  blocks up to the one LLaVA reads (attention, the top-k experts, the
  gate) and the projector's top-k experts;
- bytes: the decoder's weights (int4 projections with float32 scales, an
  int8 lm_head) once per decoder forward in the window, the tower's and
  projector's bf16 weights once per tower forward, and the live cache:
  each decode token reads the int8 keys and values (with bf16 scales) of
  its context and writes its own; a prefill writes and reads its prompt's.
The padding, dead slots and all-expert products the program runs are not
required work, and are not counted.
"""

from harness.peaks import bound_s

LAYER = "whole step (models/llava.py, models/decoder.py)"
MOVES = "serve_tok_s"


def projection_ops(g) -> int:
    kvd = g.kv_heads * g.head_dim
    return 2 * g.layers * (g.d * (g.d + 2 * kvd) + g.d * g.d
                           + g.d * 2 * g.ffn + g.ffn * g.d)


def attention_ops(g, keys: int) -> int:
    """One query position over `keys` keys: q k^T and p v, every layer."""
    return 4 * g.layers * g.heads * g.head_dim * keys


def head_ops(g) -> int:
    return 2 * g.d * g.vocab


def image_ops(g) -> int:
    """The tower's blocks up to the one LLaVA reads, and the projector, for
    one image."""
    P, d, h, E, k = g.patches, g.v_d, g.v_ffn, g.experts, g.top_k
    block = (8 * P * d * d + 4 * P * P * d + 2 * P * d * E
             + k * 4 * P * d * h)
    return (2 * P * 3 * g.patch * g.patch * d + (g.v_layers - 1) * block
            + P * (2 * d * E + k * 2 * (d * g.d + g.d * g.d)))


def decoder_weight_bytes(g) -> int:
    kvd = g.kv_heads * g.head_dim
    shapes = [(g.d, g.d + 2 * kvd), (g.d, g.d), (g.d, 2 * g.ffn),
              (g.ffn, g.d)]
    return (g.layers * sum(k * n // 2 + 4 * n for k, n in shapes)
            + g.vocab * g.d + 4 * g.vocab)


def tower_weight_bytes(g) -> int:
    d, E = g.v_d, g.experts
    block = 4 * d * d + E * 2 * d * g.v_ffn + E * d
    proj = E * (d * g.d + g.d * g.d) + E * d
    return 2 * (3 * g.patch * g.patch * d + g.patches * d
                + (g.v_layers - 1) * block + proj)


def kv_bytes_per_position(g) -> int:
    return g.layers * 2 * (g.kv_heads * g.head_dim + 2 * g.kv_heads)


def window_work(g, records, decoder_forwards: int, tower_forwards: int,
                t0: float, t1: float):
    """(bytes, operations) of what the window served."""
    proj, head, kvb = projection_ops(g), head_ops(g), \
        kv_bytes_per_position(g)
    ops = 0
    nbytes = (decoder_forwards * decoder_weight_bytes(g)
              + tower_forwards * tower_weight_bytes(g))
    for r in records:
        for i, t in enumerate(r.times):
            if not t0 <= t < t1:
                continue
            if i == 0:
                P = r.prompt
                ops += (P * proj + head + attention_ops(g, 1)
                        * P * (P + 1) // 2 + (image_ops(g) if r.image
                                              else 0))
                nbytes += 2 * P * kvb
            else:
                keys = r.prompt + i
                ops += proj + head + attention_ops(g, keys)
                nbytes += (keys + 1) * kvb
    return nbytes, ops


def read(run):
    s = run.served
    if s.trace is None:
        return None
    t0, t1 = s.trace_window
    nbytes, ops = window_work(run.geometry, s.records, len(s.decoder_rows),
                              len(s.tower_rows), t0, t1)
    if ops == 0:
        return None
    return 100.0 * bound_s(nbytes, ops) / (t1 - t0)
