"""Training state: a plain dict tree (params, optimizer state, step), as
the JAX package's ``train/state.py``, so that checkpoints name its leaves
the same way."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .optimizer import AdamWConfig, init_opt_state, opt_logical_axes

TrainState = Dict[str, Any]  # {"params", "opt", "step"}


def init_state(params, opt_cfg: AdamWConfig) -> TrainState:
    """``step`` is an int32 0-d tensor on the optimizer count's device."""
    opt = init_opt_state(params, opt_cfg)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32,
                                device=opt["count"].device)}


def state_logical_axes(param_axes, opt_cfg: AdamWConfig):
    """The logical axes of ``init_state``'s tree, as the JAX package's:
    the parameters', the moments' (``opt_logical_axes``) and none for the
    step.  ``parallel.sharding.param_specs`` of them cut a full state into
    a rank's shards (an int8 moment's rows whole)."""
    return {"params": param_axes,
            "opt": opt_logical_axes(param_axes, opt_cfg),
            "step": ()}
