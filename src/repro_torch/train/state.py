"""Training state: a plain dict tree (params, optimizer state, step), as
the JAX package's ``train/state.py``, so that checkpoints name its leaves
the same way."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .optimizer import AdamWConfig, init_opt_state

TrainState = Dict[str, Any]  # {"params", "opt", "step"}


def init_state(params, opt_cfg: AdamWConfig) -> TrainState:
    """``step`` is an int32 0-d tensor on the optimizer count's device."""
    opt = init_opt_state(params, opt_cfg)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32,
                                device=opt["count"].device)}
