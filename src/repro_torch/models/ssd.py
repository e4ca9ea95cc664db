"""Mamba-2 SSD (state-space duality) layer: projections, causal conv, the
chunked scan through the ``ssd_scan`` kernel, gate, norm and out-projection;
and the recurrent one-token decode step.

Ported from the JAX package's ``models/ssd.py`` with one group (n_groups =
1), the same split projections (z, x, B, C, dt) and split convs (x, BC),
and the same leaf names.  The JAX code projects onto ``concat([w_B, w_C])``,
building the concatenation on every call; here B and C are two products
through the matmul kernel, so no weight is copied, and the conv of the
2N BC channels runs as two convs of N, which is the same depthwise conv.

Over a mesh, a decode cache cut by ``parallel.sharding.cache_specs`` holds
each rank's heads of the SSM ``state`` (where the model axis divides
them) and the whole conv tails: the decode step updates this rank's heads
with their slices of dt, ``A_log``, ``dt_bias``, ``D`` and x, and gathers
y over the model axis before the gated norm and ``w_out``, which need
every head.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel import collectives as coll
from .attention import _linear
from .common import (Params, dense_init, get_mesh_context, normal_init,
                     rmsnorm)


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


def ssd_axes(cfg) -> Dict[str, tuple]:
    """``ssd_init``'s logical axes (the JAX package's): the head-parallel
    leaves over "heads", B and C replicated."""
    return {
        "w_z": ("embed", "heads"), "w_x": ("embed", "heads"),
        "w_B": ("embed", None), "w_C": ("embed", None),
        "w_dt": ("embed", "heads"),
        "conv_x": (None, "heads"), "conv_BC": (None, None),
        "A_log": ("heads",), "D": ("heads",), "dt_bias": ("heads",),
        "norm": ("heads",),
        "w_out": ("heads", "embed"),
    }


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
                   dtype) -> torch.Tensor:
    """(y * silu(z)) -> RMSNorm -> out-projection, rounding as JAX does."""
    y = y.to(dtype) * F.silu(z.float()).to(dtype)
    return _linear(rmsnorm(y, p["norm"], cfg.rms_eps), p["w_out"])


def ssd_forward(cfg, p: Params, x: torch.Tensor, *,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B,S,d) -> (y (B,S,d), decode cache): the final SSM state and the
    last K-1 pre-conv inputs of each conv, which seed decoding."""
    H, P, N, K = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, \
        cfg.ssm_conv_width
    Bsz, S = x.shape[0], x.shape[1]
    z = _linear(x, p["w_z"])
    xin_pre = _linear(x, p["w_x"])
    B_pre = _linear(x, p["w_B"])
    C_pre = _linear(x, p["w_C"])
    dt = _linear(x, p["w_dt"])

    xin = _causal_conv(xin_pre, p["conv_x"])
    Bm = _causal_conv(B_pre, p["conv_BC"][:, :N])
    Cm = _causal_conv(C_pre, p["conv_BC"][:, N:])

    A = -torch.exp(p["A_log"])
    dt = F.softplus(dt.float() + p["dt_bias"])
    xh = xin.reshape(Bsz, S, H, P)
    y, state = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk,
                            init_state=init_state)
    y = y.float() + xh.float() * p["D"][None, None, :, None]
    y = _gate_norm_out(cfg, p, y.reshape(Bsz, S, H * P), z, x.dtype)
    cache = {"state": state,
             "conv_x": xin_pre[:, S - (K - 1):],
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


def _conv_step(buf: torch.Tensor, xt: torch.Tensor, w: torch.Tensor
               ) -> torch.Tensor:
    """buf (B,K-1,C) holds the previous inputs, xt (B,C) the new one.
    Shifts ``buf`` in place and returns silu(conv) (B,C)."""
    full = torch.cat([buf, xt[:, None, :]], dim=1)           # (B,K,C)
    y = torch.einsum("bkc,kc->bc", full.float(), w.float())
    buf.copy_(full[:, 1:])
    return F.silu(y).to(xt.dtype)


def ssd_decode_step(cfg, p: Params, x: torch.Tensor,
                    cache: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B,1,d) -> (y (B,1,d), cache).  The state and conv tails are
    updated in place (``copy_``): the caller passes views of the stacked
    cache, which must advance.  Plain PyTorch, as the JAX package's step is
    plain jnp; nothing here waits on the card.  A ``state`` of fewer than
    H heads is this rank's block of a state split over the mesh's model
    axis (the module docstring)."""
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    state = cache["state"]
    Hl = state.shape[1]
    h0 = 0
    if Hl != H:
        mesh, _, model_axis = get_mesh_context()
        if mesh is None or Hl * coll.axis_size(mesh, model_axis) != H:
            raise ValueError(f"an SSM state of {Hl} heads of {H}, but not "
                             "a model-axis block of a mesh")
        h0 = coll.axis_index(mesh, model_axis) * Hl
    heads = slice(h0, h0 + Hl)
    xt = x[:, 0, :]
    z = _linear(xt, p["w_z"])
    xin = _linear(xt, p["w_x"])
    BC = torch.cat([_linear(xt, p["w_B"]), _linear(xt, p["w_C"])], dim=-1)
    dt = _linear(xt, p["w_dt"])

    xin = _conv_step(cache["conv_x"], xin, p["conv_x"])
    BC = _conv_step(cache["conv_BC"], BC, p["conv_BC"])
    Bm, Cm = BC[:, :N].float(), BC[:, N:].float()

    A = -torch.exp(p["A_log"][heads])
    dt = F.softplus(dt.float() + p["dt_bias"])[:, heads]     # (B,Hl)
    dA = torch.exp(dt * A)
    xh = xin.reshape(-1, H, P)[:, heads].float()
    state.copy_(state * dA[..., None, None] +
                torch.einsum("bn,bhp,bh->bhpn", Bm, xh, dt))
    y = torch.einsum("bn,bhpn->bhp", Cm, state)
    y = y + xh * p["D"][heads][None, :, None]
    if Hl != H:
        y = coll.gather_to_replicated(y, mesh, model_axis, 1)
    y = _gate_norm_out(cfg, p, y.reshape(-1, H * P), z, x.dtype)
    return y[:, None, :], cache
