"""The training step (grad -> clip -> AdamW) with gradient accumulation,
straggler detection and the single-process training driver with
checkpoints.

Ported from the JAX package's ``train/loop.py``.  Gradients come from
autograd through the model's ops: on the card every product and attention
of the forward and the backward is a kernel launch (``kernels/ops.py``).
PyTorch runs eagerly, so nothing is jitted; ``train_loop`` takes a seed
where the JAX package takes a key.  ``TrainConfig.compress_grads`` is
declared and never read, as there.

Over a mesh (``make_train_step(..., mesh=, specs=)``, the model's mesh
context set, each rank holding its local shards and its data shard of the
batch), autograd already gives each rank the gradient of its shard: the
layers' gathers sum a data-sharded leaf's gradient over the data axes and
take a model-sharded leaf's slice of the gradient of the replicated
compute (``models/lm.py``).  The step then sums over the data axes the
gradient of every leaf that is replicated over them, and AdamW runs on
the shards (int8 moments with whole rows: ``train/optimizer.py``); the
gradient norm sums each leaf once.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..models.common import map_tree, tree_leaves
from .optimizer import AdamWConfig, adamw_update
from .state import TrainState, init_state


@dataclasses.dataclass
class TrainConfig:
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    grad_accum: int = 1
    compress_grads: bool = False      # int8 all-reduce w/ error feedback
    straggler_threshold: float = 3.0  # x median step time triggers the hook


def loss_and_grads(loss_fn: Callable, params, batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, grads) of ``loss_fn(params, batch)``: the gradient of
    every parameter leaf in its dtype (zeros for a leaf the loss does not
    reach), the loss and metrics detached."""
    live = map_tree(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        leaves = list(tree_leaves(live))
        flat = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(flat)
    grads = map_tree(lambda p: _or_zeros(next(it), p), live)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _or_zeros(g: Optional[torch.Tensor], p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, requires_grad=False) if g is None else g


def sum_over_data(grads, specs, mesh):
    """Each leaf's gradient summed over the batch's data axes that do not
    shard it (a leaf replicated over them saw one data shard per rank)."""
    from ..parallel.collectives import psum_raw
    from ..parallel.sharding import batch_axes, sharded_axes

    def one(g, spec):
        axes = tuple(a for a in batch_axes(mesh)
                     if a not in sharded_axes(spec))
        return psum_raw(g, mesh, axes) if axes else g
    return map_tree(one, grads, specs)


def make_train_step(loss_fn: Callable, tcfg: TrainConfig,
                    compress_fn: Optional[Callable] = None, *,
                    mesh=None, specs=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    With grad_accum > 1 the batch's leading dim is split into microbatches
    in order, their fp32 gradients summed and averaged, and the loss
    averaged.  ``mesh`` and ``specs`` (each parameter leaf's spec,
    ``parallel.sharding.param_specs``): the step over a mesh (the module
    docstring), its state cut by the specs of ``state_logical_axes``.
    """

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = state["params"]
        n = tcfg.grad_accum
        if n > 1:
            def micro(i):
                return {k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
                        if x.dim() else x for k, x in batch.items()}

            grads = map_tree(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=state["step"].device)
            for i in range(n):
                loss, _, g = loss_and_grads(loss_fn, params, micro(i))
                grads = map_tree(torch.add, grads, g)
                loss_sum = loss_sum + loss
            grads = map_tree(lambda g: g / n, grads)
            metrics = {"loss": loss_sum / n}
        else:
            _, metrics, grads = loss_and_grads(loss_fn, params, batch)

        if mesh is not None:
            grads = sum_over_data(grads, specs, mesh)
        if compress_fn is not None:
            grads = compress_fn(grads)

        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, state["opt"], tcfg.opt, specs=specs, mesh=mesh)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# host-side driver with fault-tolerance hooks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepTimer:
    """Straggler detection: per-step wall times; flags steps that exceed
    ``threshold`` x the running median."""
    threshold: float = 3.0
    times: List[float] = dataclasses.field(default_factory=list)
    stragglers: List[int] = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        med = sorted(self.times)[len(self.times) // 2]
        slow = len(self.times) >= 5 and dt > self.threshold * med
        if slow:
            self.stragglers.append(step)
        return slow


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (``data.make_batch``) or tensors on
    ``device``, dtypes kept."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train_loop(bundle, tcfg: TrainConfig, data_iter: Iterable, *,
               n_steps: int, state: Optional[TrainState] = None,
               seed: Optional[int] = None, device=None,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 0,
               on_straggler: Optional[Callable[[int], None]] = None,
               log_every: int = 10) -> Tuple[TrainState, List[Dict]]:
    """Single-process training driver.  Without ``state``, the parameters
    are ``bundle.init(seed or 0, device)`` (``device=None``: the card).
    Each step's wall time ends when the card has finished the step.  Logs
    the 0-d metrics of every ``log_every``-th step and of the last; saves
    a checkpoint every ``checkpoint_every`` steps."""
    from ..checkpoint.ckpt import save_checkpoint

    if state is None:
        params = bundle.init(seed if seed is not None else 0, device=device)
        state = init_state(params, tcfg.opt)
    device = state["step"].device
    step_fn = make_train_step(bundle.loss, tcfg)
    timer = StepTimer(tcfg.straggler_threshold)
    history: List[Dict] = []
    start = int(state["step"])
    for i, batch in enumerate(data_iter):
        if i >= n_steps:
            break
        batch = to_device(batch, device)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        if timer.record(start + i, dt) and on_straggler:
            on_straggler(start + i)
        if (i % log_every) == 0 or i == n_steps - 1:
            history.append({k: float(v) for k, v in metrics.items()
                            if v.dim() == 0})
        if checkpoint_dir and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, state, step=start + i + 1)
    return state, history
