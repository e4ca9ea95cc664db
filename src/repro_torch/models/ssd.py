"""Mamba-2 SSD (state-space duality) layer: projections, causal conv, the
chunked scan through the ``ssd_scan`` kernel, gate, norm and out-projection;
and the recurrent one-token decode step.

Ported from the JAX package's ``models/ssd.py`` with one group (n_groups =
1), the same split projections (z, x, B, C, dt) and split convs (x, BC),
and the same leaf names.  The JAX code projects onto ``concat([w_B, w_C])``,
building the concatenation on every call; here B and C are two products
through the matmul kernel, so no weight is copied, and the conv of the
2N BC channels runs as two convs of N, which is the same depthwise conv.

Over a mesh whose model axis of M > 1 ranks divides the heads
(``heads_parallel``), the block is tensor-parallel over its heads, as
GSPMD partitions the JAX package's under ``param_rules`` ("heads" over
the model axis): z, x and dt are column-parallel products (the rank's
columns of ``w_z``, ``w_x`` and ``w_dt``, the replicated input entering
through ``copy_to_split``), the x conv runs on the rank's channels with
its block of ``conv_x``, and the scan on its H/M heads with its slices
of ``A_log``, ``dt_bias`` and ``D``.  B and C (``w_B``, ``w_C``,
``conv_BC``) stay replicated and enter the rank's scan through
``copy_to_split``, so their gradients are summed over the axis.  The
gated RMSNorm runs over all of ``d_inner``: each rank's fp32 sum of
squares is summed over the axis (``psum_for_local_use``: every rank
normalizes its own block with the sum, so the backward sums too), then
scaled by the rank's block of ``norm``; ``w_out`` is row-parallel (the
partial outputs summed over the axis in rank order).  Prefill's cache
then holds the rank's heads of the state and the whole x conv tail
(gathered over the axis), as ``parallel.sharding.cache_specs`` cuts a
decode cache; the decode step runs the same split on one token: the rank
convolves its channel block of the whole tail, and the tail advances
with the step's x columns gathered over the axis (B x ``d_inner``
elements a layer), so every rank's tail stays whole and equal.  Where M
does not divide the heads the head leaves are replicated over the model
axis (``ssd_axes``) and the block computes on whole leaves on every
rank, as the state is whole under ``cache_specs``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel import collectives as coll
from .attention import _linear
from .common import (Params, TensorParallel, dense_init, normal_init,
                     rmsnorm, tensor_parallel)


def ssd_init(cfg, gen: torch.Generator, dtype, device) -> Params:
    """``A_log``, ``D`` and ``dt_bias`` are fp32 whatever ``dtype`` is."""
    d, di, H, N = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    K = cfg.ssm_conv_width

    def conv(channels):
        return normal_init(gen, (K, channels), 0.1, dtype, device)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_z": dense_init(gen, (d, di), dtype, device),
        "w_x": dense_init(gen, (d, di), dtype, device),
        "w_B": dense_init(gen, (d, N), dtype, device),
        "w_C": dense_init(gen, (d, N), dtype, device),
        "w_dt": dense_init(gen, (d, H), dtype, device),
        "conv_x": conv(di),
        "conv_BC": conv(2 * N),
        "A_log": torch.zeros((H,), **f32),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm": torch.ones((di,), dtype=dtype, device=device),
        "w_out": dense_init(gen, (di, d), dtype, device, in_axis=0),
    }


def ssd_axes(cfg, model_size: int = 1) -> Dict[str, tuple]:
    """``ssd_init``'s logical axes (the JAX package's): the head-parallel
    leaves over "heads", B and C replicated.  Over a model axis of
    ``model_size`` ranks that does not divide the heads, the head leaves
    are replicated (None): a rank cannot hold whole heads, and the JAX
    package cannot place them (a dim that the axis does not divide)."""
    h = "heads" if cfg.ssm_heads % model_size == 0 else None
    return {
        "w_z": ("embed", h), "w_x": ("embed", h),
        "w_B": ("embed", None), "w_C": ("embed", None),
        "w_dt": ("embed", h),
        "conv_x": (None, h), "conv_BC": (None, None),
        "A_log": (h,), "D": (h,), "dt_bias": (h,),
        "norm": (h,),
        "w_out": (h, "embed"),
    }


def heads_parallel(cfg) -> Optional[TensorParallel]:
    """``common.tensor_parallel()`` where its M ranks each hold whole heads
    of the SSD (M divides ``cfg.ssm_heads``), else None: the block then
    computes on whole leaves."""
    tp = tensor_parallel()
    return tp if tp is not None and cfg.ssm_heads % tp.size == 0 else None


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence, then SiLU: x (B,S,C),
    w (K,C).  K shifted multiply-adds in fp32, as the JAX package does (a
    cuDNN fp32 convolution would run in TF32 by default)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + S].float() * w[i].float()
    return F.silu(out).to(x.dtype)


def _gate_norm_out(cfg, p: Params, y: torch.Tensor, z: torch.Tensor,
                   dtype, tp: Optional[TensorParallel] = None
                   ) -> torch.Tensor:
    """(y * silu(z)) -> RMSNorm -> out-projection, rounding as JAX does.
    With ``tp``, y and z are the rank's block of ``d_inner``: the sum of
    squares is summed over the axis (the norm is over every channel) and
    ``w_out`` is row-parallel (the module docstring)."""
    y = y.to(dtype) * F.silu(z.float()).to(dtype)
    if tp is None:
        return _linear(rmsnorm(y, p["norm"], cfg.rms_eps), p["w_out"])
    yf = y.float()
    ss = coll.psum_for_local_use((yf * yf).sum(dim=-1, keepdim=True),
                                 tp.mesh, tp.axis)
    y = yf * torch.rsqrt(ss / cfg.d_inner + cfg.rms_eps)
    y = (y * p["norm"].float()).to(dtype)
    return tp.row_out(_linear(y, p["w_out"]))


def ssd_forward(cfg, p: Params, x: torch.Tensor, *,
                init_state: Optional[torch.Tensor] = None,
                keep_cache: bool = True
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x (B,S,d) -> (y (B,S,d), decode cache): the final SSM state and the
    last K-1 pre-conv inputs of each conv, which seed decoding; None where
    not ``keep_cache``.  Over a model axis that divides the heads
    (``heads_parallel``) on the rank's heads (the module docstring): the
    state is the rank's heads, the x conv tail every channel's."""
    P, N, K = cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_conv_width
    tp = heads_parallel(cfg)
    Bsz, S = x.shape[0], x.shape[1]
    xc = x if tp is None else tp.column_in(x)
    z = _linear(xc, p["w_z"])
    xin_pre = _linear(xc, p["w_x"])
    B_pre = _linear(x, p["w_B"])
    C_pre = _linear(x, p["w_C"])
    dt = _linear(xc, p["w_dt"])

    xin = _causal_conv(xin_pre, p["conv_x"])
    Bm = _causal_conv(B_pre, p["conv_BC"][:, :N])
    Cm = _causal_conv(C_pre, p["conv_BC"][:, N:])
    if tp is not None:  # replicated B and C, read by the rank's heads
        Bm, Cm = tp.column_in(Bm), tp.column_in(Cm)

    A = -torch.exp(p["A_log"])
    dt = F.softplus(dt.float() + p["dt_bias"])
    xh = xin.reshape(Bsz, S, -1, P)
    y, state = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk,
                            init_state=init_state)
    y = y.float() + xh.float() * p["D"][None, None, :, None]
    y = _gate_norm_out(cfg, p, y.reshape(Bsz, S, -1), z, x.dtype, tp)
    if not keep_cache:
        return y, None
    tail = xin_pre[:, S - (K - 1):]
    if tp is not None:
        tail = coll.gather_raw(tail.detach(), tp.mesh, tp.axis, 2)
    cache = {"state": state, "conv_x": tail,
             "conv_BC": torch.cat([B_pre, C_pre], dim=-1)[:, S - (K - 1):]}
    return y, cache


# ---------------------------------------------------------------------------
# decode: recurrent single-token step
# ---------------------------------------------------------------------------

def init_ssd_cache(cfg, batch: int, dtype, device) -> Dict[str, torch.Tensor]:
    """The state in fp32, the conv tails in the param dtype."""
    H, P, N, K = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, \
        cfg.ssm_conv_width
    return {
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
        "conv_x": torch.zeros((batch, K - 1, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_BC": torch.zeros((batch, K - 1, 2 * N), dtype=dtype,
                               device=device),
    }


def _conv_out(buf: torch.Tensor, xt: torch.Tensor, w: torch.Tensor
              ) -> torch.Tensor:
    """buf (B,K-1,C) holds the previous inputs, xt (B,C) the new one:
    silu(conv) (B,C)."""
    full = torch.cat([buf, xt[:, None, :]], dim=1)           # (B,K,C)
    y = torch.einsum("bkc,kc->bc", full.float(), w.float())
    return F.silu(y).to(xt.dtype)


def _shift_(buf: torch.Tensor, xt: torch.Tensor) -> None:
    """Advance the tail ``buf`` (B,K-1,C) by the new input xt (B,C), in
    place."""
    buf.copy_(torch.cat([buf[:, 1:], xt[:, None, :]], dim=1))


def _conv_step(buf: torch.Tensor, xt: torch.Tensor, w: torch.Tensor
               ) -> torch.Tensor:
    """``_conv_out``, then the tail shifted in place."""
    y = _conv_out(buf, xt, w)
    _shift_(buf, xt)
    return y


def ssd_decode_step(cfg, p: Params, x: torch.Tensor,
                    cache: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B,1,d) -> (y (B,1,d), cache).  The state and conv tails are
    updated in place (``copy_``): the caller passes views of the stacked
    cache, which must advance.  Plain PyTorch, as the JAX package's step is
    plain jnp; nothing here waits on the card.  Over a model axis that
    divides the heads (``heads_parallel``), ``state`` is this rank's
    heads (``cache_specs``' block) and the step runs on them (the module
    docstring)."""
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    tp = heads_parallel(cfg)
    Hl = H if tp is None else H // tp.size
    state = cache["state"]
    if state.shape[1] != Hl:
        raise ValueError(f"an SSM state of {state.shape[1]} heads, where "
                         f"the step runs on {Hl} of {H} (a model-axis block "
                         "of cache_specs over a mesh that divides the heads)")
    xt = x[:, 0, :]
    xc = xt if tp is None else tp.column_in(xt)
    z = _linear(xc, p["w_z"])
    xin = _linear(xc, p["w_x"])
    BC = torch.cat([_linear(xt, p["w_B"]), _linear(xt, p["w_C"])], dim=-1)
    dt = _linear(xc, p["w_dt"])

    if tp is None:
        xin = _conv_step(cache["conv_x"], xin, p["conv_x"])
    else:  # the rank's channels of the whole tail; the tail advances whole
        lo = tp.index * xin.shape[-1]
        tail = cache["conv_x"]
        conv = _conv_out(tail[:, :, lo:lo + xin.shape[-1]], xin, p["conv_x"])
        _shift_(tail, coll.gather_raw(xin, tp.mesh, tp.axis, 1))
        xin = conv
    BC = _conv_step(cache["conv_BC"], BC, p["conv_BC"])
    Bm, Cm = BC[:, :N].float(), BC[:, N:].float()

    A = -torch.exp(p["A_log"])
    dt = F.softplus(dt.float() + p["dt_bias"])               # (B,Hl)
    dA = torch.exp(dt * A)
    xh = xin.reshape(-1, Hl, P).float()
    state.copy_(state * dA[..., None, None] +
                torch.einsum("bn,bhp,bh->bhpn", Bm, xh, dt))
    y = torch.einsum("bn,bhpn->bhp", Cm, state)
    y = y + xh * p["D"][None, :, None]
    y = _gate_norm_out(cfg, p, y.reshape(-1, Hl * P), z, x.dtype, tp)
    return y[:, None, :], cache
