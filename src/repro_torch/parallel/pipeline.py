"""GPipe-style pipeline parallelism over one mesh axis (``pod``).

The port of the JAX package's ``parallel/pipeline.py``: the ranks along
the axis hold disjoint layer ranges (one stage each) and microbatches
stream through them by ``ppermute``, over n_micro + P - 1 steps, which
gives the classic (P - 1) / (P - 1 + n_micro) bubble fraction.  An opt-in
recipe, as there: the default layout keeps pods data-parallel.

Where the JAX package runs one program over the axis (``shard_map`` of a
``lax.scan``), each rank here runs the same steps on its own tensors and
calls the autograd collectives of ``collectives.py``.  Every rank builds
the same graph -- the selections are ``torch.where`` on the rank's stage
index, as the reference's ``jnp.where`` -- so that in the backward every
rank runs the same inverse ``ppermute``s in the same order: a rank whose
graph skipped one would leave its partner waiting.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.common import map_tree, tree_leaves
from .collectives import axis_index, axis_size, copy_to_split, ppermute, psum


def pipeline_forward(stage_fn: Callable, x_micro: torch.Tensor, *, mesh,
                     axis: str = "pod", stage_params=None) -> torch.Tensor:
    """Run ``stage_fn(params, x)`` as a P-stage pipeline over ``axis``.

    x_micro: (n_micro, micro_batch, ...), the same on every rank of the
    axis; microbatches stream in sequence.  stage_params: this rank's
    stage, the block of a tree whose leading dim is the stage count, cut
    along ``axis`` (a leading dim of 1, as ``shard_map`` hands it to the
    reference's body); ``stage_fn`` gets it without that dim and returns a
    tensor of its input's shape.  Returns the pipeline's output
    microbatches (x_micro's shape), the same on every rank.

    The schedule is the reference's, step for step: at step t stage 0
    takes microbatch min(t, n_micro - 1), every other stage the tensor its
    predecessor sent at step t - 1; every stage runs ``stage_fn`` at every
    step, bubble steps included, and sends its output to the next
    (i -> i + 1); the last stage's output at step t is microbatch
    t - (P - 1) of the result, and a sum over the axis masked to the last
    stage replicates the result.  Differentiable with respect to the stage
    parameters (each rank gets its own block's gradient) and to
    ``x_micro`` (every rank gets the whole gradient)."""
    P = axis_size(mesh, axis)
    stage = axis_index(mesh, axis)
    n_micro = x_micro.shape[0]
    for leaf in tree_leaves(stage_params):
        if leaf.shape[:1] != (1,):
            raise ValueError(f"stage_params: a leaf of shape "
                             f"{tuple(leaf.shape)}, not this rank's block "
                             f"(leading dim 1) of the {P} stages")
    params = map_tree(lambda a: a[0], stage_params)
    first = torch.tensor(stage == 0, device=x_micro.device)
    last = torch.tensor(stage == P - 1, device=x_micro.device)
    # replicated on entry: the backward sums the ranks' cotangents (stage
    # 0's alone are not zero)
    xm = copy_to_split(x_micro, mesh, axis)
    perm = [(i, i + 1) for i in range(P - 1)]
    buf = torch.zeros_like(x_micro[0])
    outs = []
    for t in range(n_micro + P - 1):
        x_in = torch.where(first, xm[min(t, n_micro - 1)], buf)
        y = stage_fn(params, x_in)
        buf = ppermute(y, mesh, axis, perm)
        if t >= P - 1:
            outs.append(y)
    out = torch.stack(outs)
    return psum(torch.where(last, out, torch.zeros_like(out)), mesh, axis)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Classic GPipe bubble: (P-1) / (P-1+m)."""
    return (n_stages - 1) / (n_stages - 1 + n_micro)
