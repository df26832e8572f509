"""Expert-FFN kernels: the XShare masked expert FFN (``moe_ffn``) and the
sort-based grouped expert FFN (``grouped_ffn``), each with its plain
PyTorch version beside it.

A wrapper sends a CPU tensor to the plain version and a CUDA tensor to
the hand-written kernel (``csrc/moe_ffn.cu``, ``csrc/grouped_ffn.cu``);
there is no other fallback. Each wrapper counts its launches in a plain
integer attribute, ``moe_ffn.launches`` / ``grouped_ffn.launches``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

MAX_TOKENS = 32   # moe_ffn holds the tokens in registers: T <= 32


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(name: str, dev: torch.device, **tensors) -> None:
    for k, t in tensors.items():
        _require(t.device == dev, f"{name}: {k} on {t.device}, want {dev}")
        _require(t.is_contiguous(), f"{name}: {k} must be contiguous")


# ------------------------------------------------------------ moe_ffn ---

def moe_ffn_plain(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                  w2: torch.Tensor, combine: torch.Tensor,
                  active: torch.Tensor) -> torch.Tensor:
    """y = sum_e active_e * combine[:, e] * FFN_e(x), computed for every
    expert in f32 (the JAX package's ``ref.moe_ffn_ref``).

    x: (T, d); w1/w3: (E, d, f); w2: (E, f, d); combine: (T, E);
    active: (E,) bool."""
    xf = x.float()
    h = torch.einsum("td,edf->etf", xf, w1.float())
    g = torch.einsum("td,edf->etf", xf, w3.float())
    y_e = torch.einsum("etf,efd->etd", F.silu(h) * g, w2.float())
    w = torch.where(active[:, None], combine.T.float(), 0.0)   # (E, T)
    return torch.einsum("etd,et->td", y_e, w).to(x.dtype)


def _splits(d: int, f: int) -> tuple:
    """How many blocks split the up pass's d and the down pass's f: about
    512 rows of d and 256 of f each, so that no block walks a long
    reduction alone and granite-moe's shape gives ~450 up and ~900 down
    blocks for 132 SMs."""
    return max(1, (d + 256) // 512), max(1, (f + 128) // 256)


def moe_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
            w2: torch.Tensor, combine: torch.Tensor, active: torch.Tensor,
            *, max_active: int) -> torch.Tensor:
    """XShare masked expert FFN over at most ``max_active`` selected
    experts; on the GPU only their weights are read.

    ``max_active`` must bound ``active.sum()`` (the policy's budget,
    ``models.moe.policy_max_active``): the kernel runs the first
    max_active active experts in index order. Each block of the kernel
    finds its slot's expert id from ``active`` itself, so a call with an
    f32 ``combine`` (routing's, a column slice, is taken as it is) is at
    most three kernel launches and no other device op, and no host sync.
    Checking the bound on the device would cost a host sync per layer;
    the tests hold every policy to it instead.
    """
    if x.device.type == "cpu":
        return moe_ffn_plain(x, w1, w3, w2, combine, active)
    _require(x.device.type == "cuda", f"moe_ffn: no kernel for {x.device}")
    T, d = x.shape
    E, _, f = w1.shape
    _require(1 <= T <= MAX_TOKENS, f"moe_ffn: T={T} outside 1..{MAX_TOKENS}")
    _require(d % 8 == 0 and f % 8 == 0,
             f"moe_ffn: d={d} and f={f} must be multiples of 8")
    _require(w1.shape == w3.shape == (E, d, f) and w2.shape == (E, f, d),
             "moe_ffn: weight shapes")
    _require(combine.shape == (T, E) and active.shape == (E,),
             "moe_ffn: combine / active shapes")
    _require(x.dtype == w1.dtype == w3.dtype == w2.dtype,
             "moe_ffn: x and weights must share a dtype")
    _require(active.dtype == torch.bool, "moe_ffn: active must be bool")
    combine = combine.float()
    if combine.stride(1) != 1:   # a row stride is taken, no copy
        combine = combine.contiguous()
    _require(combine.device == x.device, f"moe_ffn: combine on "
             f"{combine.device}, want {x.device}")
    _check_cuda("moe_ffn", x.device, x=x, w1=w1, w3=w3, w2=w2,
                active=active)
    for k, t in dict(x=x, w1=w1, w3=w3, w2=w2).items():
        _require(t.data_ptr() % 16 == 0, f"moe_ffn: {k} not 16-byte aligned")
    slots = max(1, min(int(max_active), E))
    ks, fs = _splits(d, f)
    f32 = dict(dtype=torch.float32, device=x.device)
    part_up = torch.empty((slots, ks, 2, T, f), **f32)
    part_down = torch.empty((slots, fs, T, d), **f32)
    y = torch.empty((T, d), dtype=x.dtype, device=x.device)
    build.check(build.lib().moe_ffn(
        x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        combine.data_ptr(), combine.stride(0), active.data_ptr(),
        part_up.data_ptr(), part_down.data_ptr(), y.data_ptr(), T, d, f, E,
        slots, ks, fs, build.dtype_code(x), build.stream_ptr(x.device)),
        "moe_ffn")
    moe_ffn.launches += 1
    return y


moe_ffn.launches = 0


# -------------------------------------------------------- grouped_ffn ---

def grouped_ffn_plain(xs: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                      w2: torch.Tensor, tile_eid: torch.Tensor,
                      tile_valid: torch.Tensor, *,
                      block_t: int) -> torch.Tensor:
    """ys[i] = FFN_{tile_eid[i // block_t]}(xs[i]) in f32, zero for rows
    of invalid tiles — a tile-gather einsum (the JAX package's
    ``dispatch.grouped_ffn_jnp``)."""
    P, d = xs.shape
    nt = P // block_t
    xf = xs.reshape(nt, block_t, d).float()
    eid = tile_eid.long()
    h = torch.einsum("tbd,tdf->tbf", xf, w1.float()[eid])
    h = F.silu(h) * torch.einsum("tbd,tdf->tbf", xf, w3.float()[eid])
    ys = torch.einsum("tbf,tfd->tbd", h, w2.float()[eid])
    ys = ys * (tile_valid != 0).float()[:, None, None]
    return ys.reshape(P, d).to(xs.dtype)


def grouped_ffn(xs: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                w2: torch.Tensor, tile_eid: torch.Tensor,
                tile_valid: torch.Tensor, *, block_t: int) -> torch.Tensor:
    """Grouped expert FFN over an expert-sorted, tile-padded row layout
    (``models.dispatch.dispatch_plan``). xs: (P, d) with P a multiple of
    block_t; tile_eid, tile_valid: (P / block_t,). On the GPU d and f
    must be multiples of 8 and xs and the weights 16-byte aligned (the
    kernel copies them in 16-byte vectors); a call is two CUDA kernels
    (up, then down chained by programmatic dependent launch)."""
    if xs.device.type == "cpu":
        return grouped_ffn_plain(xs, w1, w3, w2, tile_eid, tile_valid,
                                 block_t=block_t)
    _require(xs.device.type == "cuda",
             f"grouped_ffn: no kernel for {xs.device}")
    P, d = xs.shape
    E, _, f = w1.shape
    _require(P % block_t == 0, f"grouped_ffn: P={P} % block_t={block_t}")
    nt = P // block_t
    _require(w1.shape == w3.shape == (E, d, f) and w2.shape == (E, f, d),
             "grouped_ffn: weight shapes")
    _require(tile_eid.shape == (nt,) and tile_valid.shape == (nt,),
             "grouped_ffn: tile vector shapes")
    _require(xs.dtype == w1.dtype == w3.dtype == w2.dtype,
             "grouped_ffn: xs and weights must share a dtype")
    _require(d % 8 == 0 and f % 8 == 0,
             f"grouped_ffn: d={d} and f={f} must be multiples of 8")
    eid = tile_eid.to(torch.int32).contiguous()
    valid = tile_valid.to(torch.int32).contiguous()
    _check_cuda("grouped_ffn", xs.device, xs=xs, w1=w1, w3=w3, w2=w2,
                tile_eid=eid, tile_valid=valid)
    for k, t in dict(xs=xs, w1=w1, w3=w3, w2=w2).items():
        _require(t.data_ptr() % 16 == 0,
                 f"grouped_ffn: {k} not 16-byte aligned")
    # H in the input dtype: bf16 rounded for the tensor cores, as
    # moe_ffn's H is; f32 stays f32
    h = torch.empty((P, f), dtype=xs.dtype, device=xs.device)
    ys = torch.empty_like(xs)
    build.check(build.lib().grouped_ffn(
        xs.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        eid.data_ptr(), valid.data_ptr(), h.data_ptr(), ys.data_ptr(), P, d,
        f, block_t, build.dtype_code(xs), build.stream_ptr(xs.device)),
        "grouped_ffn")
    grouped_ffn.launches += 1
    return ys


grouped_ffn.launches = 0
