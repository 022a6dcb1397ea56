"""Frozen operation and byte counts of the NeRF MLP and of its two kernels,
K1 (the fused forward) and K2 (the fused recompute-backward), with their
bounds at the card's peaks (``counts/h100.py``).

The counts follow from a configuration's widths alone, whatever code
computes the model: a later change to a kernel cannot move them.

* A point's forward is 2 x its multiply-adds: the dense layers'
  ``fan_in x fan_out`` each (593,408 for 8x256, 266,880 for 6x192) and
  the two encodings' phase products (3 inputs x 3F columns: 126 for 10
  positional and 4 view frequencies).
* K1's bound at N points is the larger of N forwards at the bf16 peak
  and its bytes (positions and views in, four logits out, the bf16
  weights and f32 biases once) at the HBM rate.
* K2 recomputes the forward and runs the backward: 3 forwards a point,
  with the gradients of every weight and bias written once in f32.

As the NeRF family's ``counts`` (``families/nerf.py``) it also gives
those bounds keyed as the readers read them: a forward's (K1) and a
training step's (K1 and K2).
"""

from h100_bench.counts.h100 import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S

__all__ = ["layer_shapes", "matmul_macs", "encoding_macs", "forward_flops",
           "step_flops", "parameter_count", "k1_bound_s", "k2_bound_s", "forward_bounds",
           "step_bounds"]


def encoded_widths(cfg: dict):
    """(positional, view) encoded widths: cos and sin of 3F phases, plus
    the raw 3 inputs when ``include_inputs``."""
    raw = 3 if cfg["include_inputs"] else 0
    return (6 * cfg["num_freq_pos"] + raw, 6 * cfg["num_freq_view"] + raw)


def layer_shapes(cfg: dict):
    """[(name, fan_in, fan_out)] of every dense layer, in the order the
    model registers them: the body, the opacity head, the bottleneck,
    the view layer (half width) and the color head."""
    pos, view = encoded_widths(cfg)
    width = cfg["num_channels"]
    shapes, inputs = [], pos
    for i in range(cfg["num_layers"]):
        if i in cfg["skips"]:
            inputs += pos
        shapes.append((f"layers.{i}", inputs, width))
        inputs = width
    shapes += [("opacity_out", width, 1), ("bottleneck", width, width),
               ("hidden_view", width + view, width // 2),
               ("color_out", width // 2, 3)]
    return shapes


def matmul_macs(cfg: dict) -> int:
    """Multiply-adds of one point's dense layers."""
    return sum(fan_in * fan_out for _, fan_in, fan_out in layer_shapes(cfg))


def encoding_macs(cfg: dict) -> int:
    """Multiply-adds of one point's two phase products."""
    return 9 * (cfg["num_freq_pos"] + cfg["num_freq_view"])


def forward_flops(cfg: dict) -> int:
    """Operations of one point's forward pass."""
    return 2 * (matmul_macs(cfg) + encoding_macs(cfg))


def step_flops(cfg: dict) -> int:
    """Operations of one point trained: the forward, and the backward at
    twice its cost."""
    return 3 * forward_flops(cfg)


def parameter_count(cfg: dict):
    """(weights, biases) of the model."""
    shapes = layer_shapes(cfg)
    return (sum(i * o for _, i, o in shapes), sum(o for _, _, o in shapes))


def k1_bound_s(cfg: dict, points: int) -> float:
    """The least time of K1 on ``points`` points, in seconds."""
    weights, biases = parameter_count(cfg)
    moved = points * (24 + 16) + 2 * weights + 4 * biases
    return max(points * forward_flops(cfg) / PEAK_BF16_FLOPS,
               moved / PEAK_HBM_BYTES_PER_S)


def k2_bound_s(cfg: dict, points: int) -> float:
    """The least time of K2 on ``points`` points, in seconds: positions,
    views and the logits' gradient in, the weights read and every
    gradient written once in f32."""
    weights, biases = parameter_count(cfg)
    moved = (points * (24 + 16) + 2 * weights + 4 * biases
             + 4 * (weights + biases))
    return max(3 * points * forward_flops(cfg) / PEAK_BF16_FLOPS,
               moved / PEAK_HBM_BYTES_PER_S)


def forward_bounds(cfg: dict, points: int) -> dict:
    """The least seconds of each kernel of a forward on ``points``."""
    return {"k1_bound_s": k1_bound_s(cfg, points)}


def step_bounds(cfg: dict, points: int) -> dict:
    """The least seconds of each kernel of a training step on
    ``points``: K1's forward and K2's backward."""
    return {"k1_bound_s": k1_bound_s(cfg, points),
            "k2_bound_s": k2_bound_s(cfg, points)}
