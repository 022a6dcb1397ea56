"""K5: the trainer's clipped Adam step as one hand-written Hopper kernel.

:class:`~..utils.optim.ClippedAdam` clips every gradient element to
``[-clip_value, clip_value]``, scales all gradients by ``clip_norm /
(norm + 1e-6)`` when their global L2 norm exceeds ``clip_norm``, then
takes ``torch.optim.Adam``'s step with L2 weight decay. Its plain twin
is torch's own calls, which it runs for CPU parameters
(``clip_grad_value_``, ``clip_grad_norm_``, ``Adam``): a dozen passes
over the parameters, two of them divisions by lists of 0-d tensors that
run one launch a tensor. ``csrc/clipped_adam.cu`` makes two: a norm pass
over the gradients and an update pass over g, p, m and v in torch's float
order (the source says what bounds it and how far it may differ from
torch).

* :func:`clipped_adam` launches both for CUDA tensors or raises (a
  non-f32, sparse or non-contiguous tensor, one off the first tensor's
  card); it never falls back. Each launch adds one to
  ``clipped_adam.launches`` and each call its elements to
  ``clipped_adam.elements``. A replay of a CUDA graph calls no wrapper,
  so the counts grow at capture only.
* :func:`tensor_rows` and :func:`partial_count` are its host side: the
  launch's table of tensors and the norm pass's partial sums.
* :data:`K5_ULPS`, :data:`K5_FLOOR` and :func:`ulp_distance` are its
  limits against torch's step, which the card tests and
  ``chip_smoke.py`` hold it to; :func:`compulsory_bytes` is the traffic
  of its two passes.
"""

import ctypes
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .launch import INT, PTR, KernelLibrary, on_cuda

__all__ = ["CHUNK", "K5_FLOOR", "K5_ULPS", "MAX_TENSORS", "NORM_BLOCKS",
           "clipped_adam", "compulsory_bytes", "load_kernel",
           "partial_count", "tensor_rows", "ulp_distance"]

# csrc/clipped_adam.cu's kMaxTensors, kChunk and kNormBlocks: the tensors
# of one launch, the elements of a block's unit of work and the norm
# pass's largest grid
MAX_TENSORS = 32
CHUNK = 2048
NORM_BLOCKS = 512

# K5 against torch's step with the norm clip (without it, bit for bit),
# after 20 steps: every gradient, moment and parameter within K5_ULPS
# ulps, an ulp taken of the larger of the two values' magnitudes and of
# K5_FLOOR times the largest magnitude of torch's tensor, so at K5_FLOOR
# 1 an ulp of that largest magnitude (readings and reasons at
# csrc/clipped_adam.cu)
K5_ULPS = 128
K5_FLOOR = 1.0

FLOAT = ctypes.c_float

_LIB = KernelLibrary(
    "clipped_adam.cu", "clipped_adam_error_string",
    clipped_adam_norm=(PTR, INT, INT, INT, FLOAT, PTR),
    clipped_adam_update=(PTR, INT, PTR, INT, INT, FLOAT, FLOAT, PTR, FLOAT,
                         FLOAT, FLOAT, FLOAT, FLOAT, FLOAT, FLOAT))


def load_kernel():
    """Builds (first call) and loads K5's library; returns the
    :class:`~.build.BuiltLibrary`."""
    return _LIB.load()


def tensor_rows(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                exp_avgs: Sequence[torch.Tensor],
                exp_avg_sqs: Sequence[torch.Tensor],
                steps: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The launches' tables: (count, 6) int64 rows of each tensor's p, g,
    m, v and step addresses and element count, at most
    :data:`MAX_TENSORS` rows a table. Raises unless every tensor is a
    contiguous dense f32 tensor on one card, each of g, m and v of its
    parameter's shape and each step a 0-d tensor."""
    rows = []
    device = params[0].device if params else None
    for p, g, m, v, s in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        for name, t, shape in (("parameter", p, p.shape),
                               ("gradient", g, p.shape),
                               ("exp_avg", m, p.shape),
                               ("exp_avg_sq", v, p.shape),
                               ("step", s, ())):
            if t.dtype != torch.float32 or t.layout != torch.strided \
                    or t.shape != shape or t.device != device \
                    or not t.is_contiguous():
                raise ValueError(
                    f"clipped Adam takes contiguous float32 tensors on one "
                    f"card: a {name} of shape {tuple(shape)} on {device} "
                    f"is a {t.dtype} {t.layout} tensor of shape "
                    f"{tuple(t.shape)} on {t.device} (contiguous: "
                    f"{t.layout == torch.strided and t.is_contiguous()})")
        rows.append((p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                     s.data_ptr(), p.numel()))
    table = np.asarray(rows, np.int64).reshape(-1, 6)
    return [np.ascontiguousarray(table[i:i + MAX_TENSORS])
            for i in range(0, len(table), MAX_TENSORS)]


def partial_count(table: np.ndarray) -> int:
    """The partial sums the norm pass writes for one table: one a block,
    ``min(chunks, NORM_BLOCKS)`` blocks."""
    chunks = sum(-(-int(n) // CHUNK) for n in table[:, 5])
    return max(1, min(chunks, NORM_BLOCKS))


def compulsory_bytes(elements: int) -> int:
    """The bytes K5 moves for ``elements`` values with a norm clip: the
    norm pass reads each gradient, the update reads and writes g, p, m
    and v."""
    return elements * 36


def ulp_distance(a: torch.Tensor, b: torch.Tensor,
                 floor: float = K5_FLOOR) -> float:
    """The largest ``|a - b|`` in ulps of ``max(|a|, |b|, floor *
    max|b|)`` (f32 ulps; 0.0 for empty tensors)."""
    if a.numel() == 0:
        return 0.0
    a, b = a.detach().double(), b.detach().double()
    scale = torch.maximum(torch.maximum(a.abs(), b.abs()),
                          torch.full_like(a, floor * float(b.abs().max())))
    scale = torch.clamp(scale, min=torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 23)
    return float(((a - b).abs() / ulp).max())


def clipped_adam(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor],
                 exp_avgs: Sequence[torch.Tensor],
                 exp_avg_sqs: Sequence[torch.Tensor],
                 steps: Sequence[torch.Tensor], *,
                 lr: Union[float, torch.Tensor], beta1: float, beta2: float,
                 eps: float, weight_decay: float,
                 clip_value: Optional[float],
                 clip_norm: Optional[float]) -> None:
    """One clipped Adam step of CUDA tensors, in place: ``grads`` become
    the gradients clipped by value (unless ``clip_value`` is None) and
    then by norm (unless ``clip_norm`` is None), ``steps`` (0-d f32) grow
    by one and ``params``, ``exp_avgs`` and ``exp_avg_sqs`` take torch's
    capturable Adam step at ``lr`` (a float, or a 0-d f32 tensor on the
    card, read there). Launches the norm pass (one block that adds the
    steps when there is no norm clip), then the update pass: one of
    each for every :data:`MAX_TENSORS` tensors. Raises for CPU tensors:
    their step is torch's (``utils.optim.ClippedAdam``)."""
    if not params:
        return
    device = params[0].device
    if not on_cuda(params[0], "clipped Adam"):
        raise ValueError("clipped Adam's kernel takes CUDA tensors; CPU "
                         "parameters take torch's Adam (ClippedAdam)")
    tables = tensor_rows(params, grads, exp_avgs, exp_avg_sqs, steps)
    lr_ptr, lr_value = None, 0.0
    if isinstance(lr, torch.Tensor):
        if lr.dtype != torch.float32 or lr.dim() != 0 or lr.device != device:
            raise ValueError(f"the learning rate must be a 0-d float32 "
                             f"tensor on {device}, got {lr.dtype} "
                             f"{tuple(lr.shape)} on {lr.device}")
        lr_ptr = lr.data_ptr()
    else:
        lr_value = float(lr)
    norm = clip_norm is not None
    clip = clip_value is not None
    counts = [partial_count(table) for table in tables]
    partials = (torch.empty(sum(counts), dtype=torch.float32, device=device)
                if norm else None)
    first = 0
    for table, count in zip(tables, counts):
        _LIB.launch(clipped_adam, "clipped_adam_norm", device,
                    table.ctypes.data, len(table), int(norm), int(clip),
                    float(clip_value or 0.0),
                    partials[first:].data_ptr() if norm else None)
        first += count
    for table in tables:
        if not table[:, 5].any():
            continue
        _LIB.launch(clipped_adam, "clipped_adam_update", device,
                    table.ctypes.data, len(table),
                    partials.data_ptr() if norm else None,
                    len(partials) if norm else 0, int(clip),
                    float(clip_value or 0.0), float(clip_norm or 0.0),
                    lr_ptr, lr_value, beta1, beta2, 1.0 - beta1, 1.0 - beta2,
                    eps, weight_decay)
    clipped_adam.elements += int(sum(int(t[:, 5].sum()) for t in tables))


clipped_adam.launches = 0
clipped_adam.elements = 0
