"""Post-processing color pipeline: ACES filmic tonemap + gamma.

Same transform as ``learn_path_tracing_tpu.core.color`` (the reference's
stages 6-10 display transform): fitted ACES (Stephen Hill's RRT+ODT
approximation) followed by power-law gamma, over ``f32[..., 3]`` images.
"""

from __future__ import annotations

import numpy as np
import torch

_ACES_INPUT = np.array(
    [
        [0.59719, 0.35458, 0.04823],
        [0.07600, 0.90834, 0.01566],
        [0.02840, 0.13383, 0.83777],
    ],
    dtype=np.float32,
)

_ACES_OUTPUT = np.array(
    [
        [1.60475, -0.53108, -0.07367],
        [-0.10208, 1.10813, -0.00605],
        [-0.00327, -0.07276, 1.07602],
    ],
    dtype=np.float32,
)


def aces_tonemap(color: torch.Tensor) -> torch.Tensor:
    """ACES filmic tonemap over ``f32[..., 3]`` linear radiance."""
    m_in = torch.as_tensor(_ACES_INPUT.T, device=color.device)
    m_out = torch.as_tensor(_ACES_OUTPUT.T, device=color.device)
    v = color @ m_in
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    v = a / b
    return torch.clamp_min(v @ m_out, 0.0)


def gamma_correct(color: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """Power-law gamma encode. Negative inputs are clamped to 0."""
    return torch.clamp_min(color, 0.0) ** (1.0 / gamma)


def post_process(color: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """The stages-6..10 display transform: ACES then gamma."""
    return gamma_correct(aces_tonemap(color), gamma)
