"""Activation catalog — the names of ND4J's Activation enum.

Counterpart of ``deeplearning4j_tpu/ops/activations.py``: the same name
table, so a JSON config's ``activation`` resolves to the same function in
both packages. Each activation is a plain PyTorch function; gradients come
from autograd.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def identity(x):
    return x


def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def leakyrelu(x, alpha: float = 0.01):
    return F.leaky_relu(x, negative_slope=alpha)


def elu(x, alpha: float = 1.0):
    return F.elu(x, alpha=alpha)


def selu(x):
    return F.selu(x)


def gelu(x):
    # reference GELU (ActivationGELU) is the tanh approximation
    return F.gelu(x, approximate="tanh")


def swish(x):
    return F.silu(x)


def mish(x):
    return F.mish(x)


def sigmoid(x):
    return torch.sigmoid(x)


def hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def tanh(x):
    return torch.tanh(x)


def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


def rationaltanh(x):
    # 1.7159 * sign(y) * (1 - 1/(1+|y|+y^2+1.41645*y^4)), y = 2x/3
    y = 2.0 * x / 3.0
    a = torch.abs(y)
    approx = 1.0 - 1.0 / (1.0 + a + y * y + 1.41645 * (y ** 4))
    return 1.7159 * torch.sign(y) * approx


def rectifiedtanh(x):
    return torch.clamp_min(torch.tanh(x), 0.0)


def softplus(x):
    return F.softplus(x)


def softsign(x):
    return F.softsign(x)


def cube(x):
    return x ** 3


def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)


def logsoftmax(x, axis: int = -1):
    return torch.log_softmax(x, dim=axis)


def thresholdedrelu(x, theta: float = 1.0):
    return torch.where(x > theta, x, torch.zeros_like(x))


def rrelu(x, lower: float = 1.0 / 8.0, upper: float = 1.0 / 3.0):
    # inference-mode RReLU: slope = mean of the range
    return torch.where(x >= 0, x, x * ((lower + upper) / 2.0))


def prelu(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


ACTIVATIONS: Dict[str, Callable] = {
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "relu6": relu6,
    "leakyrelu": leakyrelu,
    "elu": elu,
    "selu": selu,
    "gelu": gelu,
    "swish": swish,
    "mish": mish,
    "sigmoid": sigmoid,
    "hardsigmoid": hardsigmoid,
    "tanh": tanh,
    "hardtanh": hardtanh,
    "rationaltanh": rationaltanh,
    "rectifiedtanh": rectifiedtanh,
    "softplus": softplus,
    "softsign": softsign,
    "cube": cube,
    "softmax": softmax,
    "logsoftmax": logsoftmax,
    "thresholdedrelu": thresholdedrelu,
    "rrelu": rrelu,
}


def get_activation(name_or_fn) -> Callable:
    """Resolve an activation by enum name (case-insensitive) or callable."""
    if callable(name_or_fn):
        return name_or_fn
    name = str(name_or_fn).lower()
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation '{name_or_fn}'; known: {sorted(ACTIVATIONS)}"
        ) from None
