"""Expert-FFN kernels: the XShare masked expert FFN (``moe_ffn``) and its
gradient (``moe_ffn_bwd``), the sort-based grouped expert FFN
(``grouped_ffn``) and its gradient (``grouped_ffn_bwd``), each with its
plain PyTorch version beside it.

A wrapper sends a CPU or meta tensor to the plain version (on meta it
only propagates shapes) and a CUDA tensor to the hand-written kernel
(``csrc/moe_ffn.cu``, ``csrc/moe_ffn_bwd.cu``, ``csrc/grouped_ffn.cu``,
``csrc/grouped_ffn_bwd.cu``); there is no other fallback. Each wrapper
counts its launches in a plain integer attribute, ``moe_ffn.launches``,
``moe_ffn_bwd.launches``, ``grouped_ffn.launches``,
``grouped_ffn_bwd.launches``.

Under autograd ``moe_ffn`` and ``grouped_ffn`` are
``torch.autograd.Function``s (``MoeFFN``, ``GroupedFFN``) whose
backwards are ``moe_ffn_bwd`` and ``grouped_ffn_bwd``.
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

    When autograd records (grad enabled and x, a weight or combine
    requires grad) the call goes through ``MoeFFN``, whose backward is
    ``moe_ffn_bwd``: the kernel on the card, the plain gradient on the
    CPU.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, w3, w2, combine)):
        return MoeFFN.apply(x, w1, w3, w2, combine, active, max_active)
    return _moe_ffn(x, w1, w3, w2, combine, active, max_active=max_active)


def _moe_ffn(x, w1, w3, w2, combine, active, *,
             max_active: int) -> torch.Tensor:
    """moe_ffn's forward: the plain version on the CPU, the kernel on the
    card."""
    if x.device.type in build.PLAIN_DEVICES:
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


class MoeFFN(torch.autograd.Function):
    """moe_ffn with its gradient: the forward is the kernel (or its plain
    version on the CPU) as it is; the backward recomputes the SwiGLU's
    pre-activations from the saved tokens and weights, so the forward
    stores nothing extra. x, the weights and combine get gradients;
    active and max_active none."""

    @staticmethod
    def forward(ctx, x, w1, w3, w2, combine, active, max_active):
        ctx.save_for_backward(x, w1, w3, w2, combine, active)
        ctx.max_active = max_active
        return _moe_ffn(x, w1, w3, w2, combine, active,
                        max_active=max_active)

    @staticmethod
    def backward(ctx, dy):
        x, w1, w3, w2, combine, active = ctx.saved_tensors
        dx, dw1, dw3, dw2, dcombine = moe_ffn_bwd(
            x, w1, w3, w2, combine, active, dy.to(x.dtype).contiguous(),
            max_active=ctx.max_active)
        return dx, dw1, dw3, dw2, dcombine.to(combine.dtype), None, None


def _slot_mask(active: torch.Tensor, max_active: int) -> torch.Tensor:
    """(E,) bool: the forward kernel's slots, the first max_active active
    experts in index order."""
    return active & (torch.cumsum(active.long(), 0) <= max_active)


def moe_ffn_bwd_plain(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                      w2: torch.Tensor, combine: torch.Tensor,
                      active: torch.Tensor, dy: torch.Tensor, *,
                      max_active: int):
    """The gradient of moe_ffn for the output gradient dy (T, d), written
    out in f32 for every expert: with A = x W1[e], B = x W3[e],
    s = sigmoid(A), H = silu(A) B, c = combine[:, e] and G = dy W2[e]^T,

      dA = c G B s (1 + A (1 - s)),  dB = c G silu(A),
      dx = sum_e dA W1[e]^T + dB W3[e]^T,
      dW1[e] = x^T dA,  dW3[e] = x^T dB,  dW2[e] = (c H)^T dy,
      dcombine[t, e] = sum_f G H = <dy_t, H_e(t) W2[e]>,

    with every expert outside the slots (the first max_active active
    experts, the ones the kernel runs) masked to zero weight gradients
    and a zero dcombine column. So a column of combine that is all zero
    (an inactive expert) gets 0, where the JAX package's vjp of its
    dense path gives <dy, y_e>: within the slots the kernel can only give
    that for the experts it runs. The router's gradient does not change:
    combine's columns come from route()'s weights, and a pick of weight
    0 (restricted_topk outside the selected set) has its weight set by
    ``torch.where``, which passes its gradient to nothing.

    Returns (dx, dw1, dw3, dw2, dcombine) in the dtypes of x, the
    weights and combine."""
    slot = _slot_mask(active, max_active)
    xf, dyf = x.float(), dy.float()
    w1f, w3f, w2f = w1.float(), w3.float(), w2.float()
    c = torch.where(slot[:, None], combine.T.float(), 0.0)[..., None]
    a = torch.einsum("td,edf->etf", xf, w1f)
    b = torch.einsum("td,edf->etf", xf, w3f)
    g = torch.einsum("td,efd->etf", dyf, w2f)
    s = torch.sigmoid(a)
    silu = a * s
    h = silu * b
    da = c * g * b * s * (1 + a * (1 - s))
    db = c * g * silu
    dx = torch.einsum("etf,edf->td", da, w1f) + \
        torch.einsum("etf,edf->td", db, w3f)
    dw1 = torch.einsum("td,etf->edf", xf, da)
    dw3 = torch.einsum("td,etf->edf", xf, db)
    dw2 = torch.einsum("etf,td->efd", c * h, dyf)
    dcombine = torch.where(slot[None, :], (g * h).sum(-1).T, 0.0)
    return (dx.to(x.dtype), dw1.to(w1.dtype), dw3.to(w3.dtype),
            dw2.to(w2.dtype), dcombine.to(combine.dtype))


BWD_STRIP = 32   # f columns a cluster of moe_ffn_bwd's kernel takes at a time


def moe_ffn_bwd(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                w2: torch.Tensor, combine: torch.Tensor,
                active: torch.Tensor, dy: torch.Tensor, *,
                max_active: int):
    """moe_ffn's gradient for the output gradient dy (T, d): returns (dx,
    dw1, dw3, dw2, dcombine), dcombine (T, E) in f32. On the card two
    CUDA kernels (csrc/moe_ffn_bwd.cu): as many thread block clusters as
    the card holds at once walk the (slot, 32-column f strip) items; a
    cluster's blocks split d, hold their rows of an item's weights once,
    sum A, B and G through distributed shared memory and write the
    weight gradients, each cluster adding its items' dx to one part (the
    experts outside the slots get zeros); then dx and dcombine summed in
    a fixed order. f32 scratch, no atomics, so two calls give the same
    bits. The forward's checks hold: T <= MAX_TOKENS, d and f multiples
    of 8, x, dy and the weights of one dtype and 16-byte aligned;
    combine is taken with a row stride, without a copy. On the CPU the
    plain version."""
    if x.device.type in build.PLAIN_DEVICES:
        return moe_ffn_bwd_plain(x, w1, w3, w2, combine, active, dy,
                                 max_active=max_active)
    _require(x.device.type == "cuda",
             f"moe_ffn_bwd: no kernel for {x.device}")
    T, d = x.shape
    E, _, f = w1.shape
    _require(1 <= T <= MAX_TOKENS,
             f"moe_ffn_bwd: T={T} outside 1..{MAX_TOKENS}")
    _require(d % 8 == 0 and f % 8 == 0,
             f"moe_ffn_bwd: d={d} and f={f} must be multiples of 8")
    _require(w1.shape == w3.shape == (E, d, f) and w2.shape == (E, f, d),
             "moe_ffn_bwd: weight shapes")
    _require(combine.shape == (T, E) and active.shape == (E,)
             and dy.shape == (T, d),
             "moe_ffn_bwd: combine / active / dy shapes")
    _require(x.dtype == dy.dtype == w1.dtype == w3.dtype == w2.dtype,
             "moe_ffn_bwd: x, dy and weights must share a dtype")
    _require(active.dtype == torch.bool, "moe_ffn_bwd: active must be bool")
    cf = combine.float()
    if cf.stride(1) != 1:   # a row stride is taken, no copy
        cf = cf.contiguous()
    _require(cf.device == x.device, f"moe_ffn_bwd: combine on "
             f"{cf.device}, want {x.device}")
    _check_cuda("moe_ffn_bwd", x.device, x=x, w1=w1, w3=w3, w2=w2, dy=dy,
                active=active)
    for k, t in dict(x=x, w1=w1, w3=w3, w2=w2, dy=dy).items():
        _require(t.data_ptr() % 16 == 0,
                 f"moe_ffn_bwd: {k} not 16-byte aligned")
    slots = max(1, min(int(max_active), E))
    ns, code = -(-f // BWD_STRIP), build.dtype_code(x)
    nparts = build.lib().moe_ffn_bwd_parts(T, d, f, slots, code)
    _require(nparts >= 1, "moe_ffn_bwd: no cluster count from the runtime")
    f32 = dict(dtype=torch.float32, device=x.device)
    p_comb = torch.empty((slots, ns, T), **f32)
    p_dx = torch.empty((nparts, T, d), **f32)
    dx = torch.empty_like(x)
    dw1, dw3, dw2 = (torch.empty_like(w) for w in (w1, w3, w2))
    dcombine = torch.empty((T, E), **f32)
    build.check(build.lib().moe_ffn_bwd(
        x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        cf.data_ptr(), cf.stride(0), active.data_ptr(), dy.data_ptr(),
        p_comb.data_ptr(), p_dx.data_ptr(), dx.data_ptr(),
        dw1.data_ptr(), dw3.data_ptr(), dw2.data_ptr(), dcombine.data_ptr(),
        T, d, f, E, slots, ns, nparts, code,
        build.stream_ptr(x.device)), "moe_ffn_bwd")
    moe_ffn_bwd.launches += 1
    return dx, dw1, dw3, dw2, dcombine


moe_ffn_bwd.launches = 0


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
    (up, then down chained by programmatic dependent launch).

    When autograd records (grad enabled and xs or a weight requires
    grad) the call goes through ``GroupedFFN``, whose backward is
    ``grouped_ffn_bwd``: the kernel on the card, the plain gradient on
    the CPU."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xs, w1, w3, w2)):
        return GroupedFFN.apply(xs, w1, w3, w2, tile_eid, tile_valid,
                                block_t)
    return _grouped_ffn(xs, w1, w3, w2, tile_eid, tile_valid,
                        block_t=block_t)


def _grouped_ffn(xs, w1, w3, w2, tile_eid, tile_valid, *,
                 block_t: int) -> torch.Tensor:
    """grouped_ffn's forward: the plain version on the CPU, the kernel on
    the card."""
    if xs.device.type in build.PLAIN_DEVICES:
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


class GroupedFFN(torch.autograd.Function):
    """grouped_ffn with its gradient: the forward is the kernel (or its
    plain version on the CPU) as it is; the backward recomputes the
    SwiGLU's pre-activations from the saved rows and weights, so the
    forward stores nothing extra. The tile vectors and block_t get no
    gradient."""

    @staticmethod
    def forward(ctx, xs, w1, w3, w2, tile_eid, tile_valid, block_t):
        ctx.save_for_backward(xs, w1, w3, w2, tile_eid, tile_valid)
        ctx.block_t = block_t
        return _grouped_ffn(xs, w1, w3, w2, tile_eid, tile_valid,
                            block_t=block_t)

    @staticmethod
    def backward(ctx, dys):
        xs, w1, w3, w2, tile_eid, tile_valid = ctx.saved_tensors
        dxs, dw1, dw3, dw2 = grouped_ffn_bwd(
            xs, w1, w3, w2, tile_eid, tile_valid,
            dys.to(xs.dtype).contiguous(), block_t=ctx.block_t)
        return dxs, dw1, dw3, dw2, None, None, None


def grouped_ffn_bwd_plain(xs: torch.Tensor, w1: torch.Tensor,
                          w3: torch.Tensor, w2: torch.Tensor,
                          tile_eid: torch.Tensor, tile_valid: torch.Tensor,
                          dys: torch.Tensor, *, block_t: int):
    """The gradient of grouped_ffn_plain written out, in f32: with
    A = xs W1[e], B = xs W3[e], s = sigmoid(A), H = silu(A) B and
    G = dys W2[e]^T per tile,

      dA = G B s (1 + A (1 - s)),  dB = G silu(A),
      dxs = dA W1[e]^T + dB W3[e]^T,
      dW1[e] = sum xs^T dA,  dW3[e] = sum xs^T dB,  dW2[e] = sum H^T dys

    over e's valid tiles; rows of invalid tiles give zeros, and an expert
    with no rows a zero weight gradient. Returns (dxs, dw1, dw3, dw2) in
    the dtypes of xs and the weights."""
    P, d = xs.shape
    E, _, f = w1.shape
    nt = P // block_t
    live = (tile_valid != 0).float()[:, None, None]
    eid = tile_eid.long()
    xf = xs.reshape(nt, block_t, d).float()
    dy = dys.reshape(nt, block_t, d).float() * live
    w1g, w3g, w2g = (w.float()[eid] for w in (w1, w3, w2))
    a = torch.einsum("tbd,tdf->tbf", xf, w1g)
    b = torch.einsum("tbd,tdf->tbf", xf, w3g)
    g = torch.einsum("tbd,tfd->tbf", dy, w2g)
    s = torch.sigmoid(a)
    silu = a * s
    da = g * b * s * (1 + a * (1 - s))
    db = g * silu
    dxs = torch.einsum("tbf,tdf->tbd", da, w1g) + \
        torch.einsum("tbf,tdf->tbd", db, w3g)

    def per_expert(t):   # (nt, ...) per-tile sums -> (E, ...)
        out = torch.zeros((E,) + t.shape[1:], dtype=t.dtype,
                          device=t.device)
        return out.index_add_(0, eid, t)
    dw1 = per_expert(torch.einsum("tbd,tbf->tdf", xf, da))
    dw3 = per_expert(torch.einsum("tbd,tbf->tdf", xf, db))
    dw2 = per_expert(torch.einsum("tbf,tbd->tfd", silu * b, dy))
    return (dxs.reshape(P, d).to(xs.dtype), dw1.to(w1.dtype),
            dw3.to(w3.dtype), dw2.to(w2.dtype))


def grouped_ffn_bwd(xs: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                    w2: torch.Tensor, tile_eid: torch.Tensor,
                    tile_valid: torch.Tensor, dys: torch.Tensor, *,
                    block_t: int):
    """grouped_ffn's gradient for the output gradient dys (P, d): returns
    (dxs, dw1, dw3, dw2). On the card three CUDA kernels
    (csrc/grouped_ffn_bwd.cu): bf16 on the tensor cores with dA, dB and
    H rounded to bf16 between them, f32 in IEEE FMAs on the CUDA cores;
    (P, f) scratches for dA, dB and H in the input dtype, and no atomics,
    so two calls give the same bits. As for grouped_ffn, d and f must be
    multiples of 8 and every operand 16-byte aligned. On the CPU the
    plain version."""
    if xs.device.type in build.PLAIN_DEVICES:
        return grouped_ffn_bwd_plain(xs, w1, w3, w2, tile_eid, tile_valid,
                                     dys, block_t=block_t)
    _require(xs.device.type == "cuda",
             f"grouped_ffn_bwd: no kernel for {xs.device}")
    P, d = xs.shape
    E, _, f = w1.shape
    _require(P % block_t == 0,
             f"grouped_ffn_bwd: P={P} % block_t={block_t}")
    nt = P // block_t
    _require(w1.shape == w3.shape == (E, d, f) and w2.shape == (E, f, d),
             "grouped_ffn_bwd: weight shapes")
    _require(dys.shape == xs.shape, "grouped_ffn_bwd: dys shape")
    _require(tile_eid.shape == (nt,) and tile_valid.shape == (nt,),
             "grouped_ffn_bwd: tile vector shapes")
    _require(xs.dtype == dys.dtype == w1.dtype == w3.dtype == w2.dtype,
             "grouped_ffn_bwd: xs, dys and weights must share a dtype")
    _require(d % 8 == 0 and f % 8 == 0,
             f"grouped_ffn_bwd: d={d} and f={f} must be multiples of 8")
    eid = tile_eid.to(torch.int32).contiguous()
    valid = tile_valid.to(torch.int32).contiguous()
    _check_cuda("grouped_ffn_bwd", xs.device, xs=xs, w1=w1, w3=w3, w2=w2,
                dys=dys, tile_eid=eid, tile_valid=valid)
    for k, t in dict(xs=xs, w1=w1, w3=w3, w2=w2, dys=dys).items():
        _require(t.data_ptr() % 16 == 0,
                 f"grouped_ffn_bwd: {k} not 16-byte aligned")
    da, db, h = (torch.empty((P, f), dtype=xs.dtype, device=xs.device)
                 for _ in range(3))
    dxs = torch.empty_like(xs)
    dw1, dw3, dw2 = (torch.empty_like(w) for w in (w1, w3, w2))
    build.check(build.lib().grouped_ffn_bwd(
        xs.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        eid.data_ptr(), valid.data_ptr(), dys.data_ptr(), da.data_ptr(),
        db.data_ptr(), h.data_ptr(), dxs.data_ptr(), dw1.data_ptr(),
        dw3.data_ptr(), dw2.data_ptr(), P, d, f, E, block_t,
        build.dtype_code(xs), build.stream_ptr(xs.device)),
        "grouped_ffn_bwd")
    grouped_ffn_bwd.launches += 1
    return dxs, dw1, dw3, dw2


grouped_ffn_bwd.launches = 0
