"""Mamba2 chunked SSD scan kernel (``csrc/ssd_scan.cu``), its gradient
kernel (``csrc/ssd_scan_bwd.cu``) and their plain PyTorch versions.

The contract is the JAX package's ``models/ssm.py ssd_chunked``: Bm and
Cm per group (head h reads group h // (nh // g)), an optional initial
state, a ragged last chunk. A CPU or meta tensor goes to the plain
version (on meta it only propagates shapes), a CUDA tensor to the
kernel; ``ssd_scan.launches`` counts the forward kernel's calls (one
call is its three passes), ``ssd_scan_bwd.launches`` the gradient's.
When autograd records, ``ssd_scan`` is ``SsdScan``, whose backward is
``ssd_scan_bwd``: the kernel on the card, ``ssd_scan_bwd_plain`` on the
CPU and meta.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

# (head dim, state width) pairs the kernel is built for: mamba2-370m,
# zamba2-1.2b, and both reduced to d_model 128
_SHAPES = ((64, 128), (64, 64), (32, 16))
# state elements a warp of ssd_scan_bwd's state pass owns (SLICE in
# csrc/ssd_scan_bwd.cu)
_STATE_SLICE = 128


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions compute in f32, or in float64 for float64
    inputs (the gradient's exact checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in f32 (the JAX package's ``ssd_chunked``):
    intra-chunk decay-masked C·Bᵀ products plus the state carried across
    chunks. The sequence is zero-padded to a chunk multiple (dt = 0 there,
    so the padding neither decays nor feeds the state).

    x: (B, S, nh, hd); dt: (B, S, nh) post-softplus; A: (nh,) negative;
    Bm, Cm: (B, S, g, ds); init_state: (B, nh, hd, ds) or None (zeros).
    Returns y (B, S, nh, hd) in x's dtype and the final state
    (B, nh, hd, ds) in f32 (float64 inputs stay float64 throughout)."""
    Bsz, S, nh, hd = x.shape
    g, ds = Bm.shape[2], Bm.shape[3]
    rep = nh // g
    l = min(chunk, S)
    Sp = -(-S // l) * l
    if Sp != S:
        x = F.pad(x, (0, 0, 0, 0, 0, Sp - S))
        dt = F.pad(dt, (0, 0, 0, Sp - S))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, Sp - S))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, Sp - S))
    nc = Sp // l
    wt = _work_dtype(x)
    xf = x.to(wt).reshape(Bsz, nc, l, nh, hd)
    dtf = dt.to(wt).reshape(Bsz, nc, l, nh)
    Bh = Bm.to(wt).reshape(Bsz, nc, l, g, ds).repeat_interleave(rep, dim=3)
    Ch = Cm.to(wt).reshape(Bsz, nc, l, g, ds).repeat_interleave(rep, dim=3)
    dA = dtf * A.to(wt)[None, None, None, :]             # (B,nc,l,nh) <= 0
    cum = torch.cumsum(dA, dim=2)

    # intra-chunk: masked before exp (above the diagonal seg > 0)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,i,j,nh)
    tri = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(tri[None, None, :, :, None], seg,
                        float("-inf")).exp()
    scores = torch.einsum("bcihs,bcjhs->bcijh", Ch, Bh)
    M = scores * decay * dtf[:, :, None, :, :]            # fold dt_j
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", M, xf)

    # each chunk's own state, then the state entering each chunk
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)     # (B,nc,l,nh)
    states = torch.einsum("bclhs,bclh,bclhp->bchps", Bh,
                          decay_states * dtf, xf)         # (B,nc,nh,hd,ds)
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B,nc,nh)
    prev = torch.zeros((Bsz, nh, hd, ds), dtype=wt,
                       device=x.device) if init_state is None \
        else init_state.to(wt)
    entering = []
    for c in range(nc):
        entering.append(prev)
        prev = prev * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)               # (B,nc,nh,hd,ds)

    y_off = torch.einsum("bcihs,bchps,bcih->bcihp", Ch, entering,
                         torch.exp(cum))
    y = (y_diag + y_off).reshape(Bsz, Sp, nh, hd)[:, :S]
    return y.to(x.dtype), prev


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan; see ``ssd_scan_plain`` for the shapes. On a CUDA
    device: x, Bm, Cm f32 or bf16 (one dtype), dt, A and init_state f32,
    (hd, ds) one of ``_SHAPES``, all contiguous; x, Bm, Cm and init_state
    16-byte aligned (the kernel reads them in 16-byte vectors).

    When autograd records (grad enabled and an input requires grad) the
    call goes through ``SsdScan``, whose backward is ``ssd_scan_bwd``:
    the gradient kernel on the card, the plain gradient on the CPU."""
    if torch.is_grad_enabled() and any(
            getattr(t, "requires_grad", False)
            for t in (x, dt, A, Bm, Cm, init_state)):
        return SsdScan.apply(x, dt, A, Bm, Cm, init_state, chunk)
    return _ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state)


def _check(name: str, x, dt, A, Bm, Cm, chunk: int, **extra) -> None:
    """The kernels' contract (forward and gradient): shapes, dtypes,
    contiguity, one device, 16-byte alignment of the vector-read
    tensors. ``extra`` are the optional (B, nh, hd, ds) f32 states and
    dy, each None or a tensor."""
    Bsz, S, nh, hd = x.shape
    g, ds = Bm.shape[2], Bm.shape[3]
    if dt.shape != (Bsz, S, nh) or A.shape != (nh,) or \
            Bm.shape != (Bsz, S, g, ds) or Cm.shape != Bm.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if S < 1 or chunk < 1 or nh % g or (hd, ds) not in _SHAPES:
        raise ValueError(f"{name}: S={S}, chunk={chunk}, nh={nh}, g={g}, "
                         f"hd={hd}, ds={ds} not supported ((hd, ds) in "
                         f"{_SHAPES}, g | nh)")
    if not (x.dtype == Bm.dtype == Cm.dtype) or \
            dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"{name}: x, Bm, Cm must share a dtype; dt and A "
                         "must be float32")
    tensors = dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm)
    for k, t in extra.items():
        if t is None:
            continue
        want = (x.shape, x.dtype) if k == "dy" else \
            ((Bsz, nh, hd, ds), torch.float32)
        if t.shape != want[0] or t.dtype != want[1]:
            raise ValueError(f"{name}: {k} must be {want[1]} "
                             f"{tuple(want[0])}")
        tensors[k] = t
    for k, t in tensors.items():
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be a contiguous "
                             f"tensor on {x.device}")
        if k not in ("dt", "A") and t.data_ptr() % 16:
            raise ValueError(f"{name}: {k} not 16-byte aligned")


def _ssd_scan(x, dt, A, Bm, Cm, *, chunk: int, init_state=None):
    """ssd_scan's forward: the plain version on the CPU, the kernel on
    the card."""
    if x.device.type in build.PLAIN_DEVICES:
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk,
                              init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for {x.device}")
    _check("ssd_scan", x, dt, A, Bm, Cm, chunk, init_state=init_state)
    Bsz, S, nh, hd = x.shape
    g, ds = Bm.shape[2], Bm.shape[3]
    l = min(chunk, S)
    nc = -(-S // l)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    final = torch.empty((Bsz, nh, hd, ds), **f32)
    cum = torch.empty((Bsz, nc, nh, l), **f32)
    states = torch.empty((Bsz, nc, nh, hd, ds), **f32)
    init_ptr = None if init_state is None else init_state.data_ptr()
    lib = build.lib()
    build.check(lib.ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), init_ptr, y.data_ptr(), final.data_ptr(),
        cum.data_ptr(), states.data_ptr(), Bsz, S, nh, hd, g, ds, l,
        build.dtype_code(x), build.stream_ptr(x.device)), "ssd_scan")
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0


class SsdScan(torch.autograd.Function):
    """ssd_scan with its gradient. The forward is the kernel (or the
    plain version on the CPU) as it is and keeps only its inputs: the
    backward recomputes cum and the states entering each chunk (under
    the train step's per-layer remat the forward runs again anyway). The
    final state's cotangent is None when no loss reads it (the train
    path), and the kernel then takes a null pointer."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                         init_state=init_state)

    @staticmethod
    def backward(ctx, dy, d_final):
        x, dt, A, Bm, Cm, init_state = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else \
            dy.to(x.dtype).contiguous()
        if d_final is not None:
            d_final = d_final.contiguous()
        dx, ddt, dA, dBm, dCm, dinit = ssd_scan_bwd(
            x, dt, A, Bm, Cm, dy, chunk=ctx.chunk, init_state=init_state,
            d_final=d_final)
        return dx, ddt, dA, dBm, dCm, \
            None if init_state is None else dinit, None


def ssd_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                       *, chunk: int,
                       init_state: Optional[torch.Tensor] = None,
                       d_final: Optional[torch.Tensor] = None):
    """The gradient of ``ssd_scan_plain`` written out in f32 (float64
    for float64 inputs), for the cotangents dy (B, S, nh, hd) and d_final
    (B, nh, hd, ds) or None. Per chunk, with cum the in-chunk cumulative
    sum of dt·A, L_ij = exp(cum_i - cum_j) where j <= i (else 0), s_ij =
    C_i·B_j, q_ij = dy_i·x_j, H_c the state entering chunk c and D_c =
    dH_{c+1} (dH_nc = d_final):

      1. G_c = Σ_i exp(cum_i) dy_i C_iᵀ;
      2. in reverse chunk order dH_c = exp(cum_last) D_c + G_c, and
         cum_last's cotangent gets exp(cum_last) <D_c, H_c>;
         d_init_state = dH_0;
      3. v_j = Σ_{i>=j} s_ij L_ij dy_i + exp(cum_last - cum_j) D_c B_j,
         dx_j = dt_j v_j, ddt_j = x_j·v_j,
         dC_i = Σ_{j<=i} q_ij L_ij dt_j B_j + exp(cum_i) H_cᵀ dy_i,
         dB_j = Σ_{i>=j} q_ij L_ij dt_j C_i
                + exp(cum_last - cum_j) dt_j D_cᵀ x_j,
         dcum_i = Σ_{j<i} w_ij - Σ_{k>i} w_ki + exp(cum_i) dy_i·(H_c C_i)
                  - r_i, w_ij = q_ij s_ij L_ij dt_j,
         r_j = exp(cum_last - cum_j) dt_j x_j·(D_c B_j), and cum_last's
         cotangent gets Σ_j r_j;
      4. da = the reverse in-chunk cumulative sum of dcum, ddt += A da,
         dA = Σ dt da; dB and dC summed over each group's heads.

    exp is taken only where j <= i (above the diagonal cum_i - cum_j > 0
    can overflow, and inf · 0 is NaN). Returns (dx, ddt, dA, dBm, dCm,
    d_init_state): x's, Bm's and Cm's dtypes, the rest f32."""
    Bsz, S, nh, hd = x.shape
    g, ds = Bm.shape[2], Bm.shape[3]
    rep = nh // g
    l = min(chunk, S)
    Sp = -(-S // l) * l
    if Sp != S:
        x, dy = (F.pad(t, (0, 0, 0, 0, 0, Sp - S)) for t in (x, dy))
        Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, Sp - S)) for t in (Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, Sp - S))
    nc = Sp // l
    wt = _work_dtype(x)
    xf = x.to(wt).reshape(Bsz, nc, l, nh, hd)
    dyf = dy.to(wt).reshape(Bsz, nc, l, nh, hd)
    dtf = dt.to(wt).reshape(Bsz, nc, l, nh)
    Bh = Bm.to(wt).reshape(Bsz, nc, l, g, ds).repeat_interleave(rep, dim=3)
    Ch = Cm.to(wt).reshape(Bsz, nc, l, g, ds).repeat_interleave(rep, dim=3)
    Af = A.to(wt)
    cum = torch.cumsum(dtf * Af, dim=2)                   # (B,nc,l,nh)
    last = cum[:, :, -1, :]                               # (B,nc,nh)
    e_last = torch.exp(last[:, :, None, :] - cum)         # exp(last - cum_j)
    e_cum = torch.exp(cum)

    # the states entering each chunk, recomputed
    own = torch.einsum("bclhp,bclhs->bchps",
                       xf * (e_last * dtf)[..., None], Bh)
    zero = torch.zeros((Bsz, nh, hd, ds), dtype=wt, device=x.device)
    prev = zero if init_state is None else init_state.to(wt)
    H = []
    for c in range(nc):
        H.append(prev)
        prev = prev * torch.exp(last[:, c])[..., None, None] + own[:, c]
    H = torch.stack(H, dim=1)                             # (B,nc,nh,hd,ds)

    # 1. chunk dstates; 2. the reverse state pass
    G = torch.einsum("bclhp,bclhs->bchps", dyf * e_cum[..., None], Ch)
    dH = zero if d_final is None else d_final.to(wt)
    D, dlast = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        D[c] = dH
        dlast[c] = torch.exp(last[:, c]) * (dH * H[:, c]).sum((-2, -1))
        dH = dH * torch.exp(last[:, c])[..., None, None] + G[:, c]
    D = torch.stack(D, dim=1)                             # (B,nc,nh,hd,ds)
    dlast = torch.stack(dlast, dim=1)                     # (B,nc,nh)

    # 3. per chunk (every chunk at once)
    tri = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,i,j,nh)
    L = torch.where(tri[None, None, :, :, None], seg, float("-inf")).exp()
    s = torch.einsum("bcihs,bcjhs->bcijh", Ch, Bh)
    q = torch.einsum("bcihp,bcjhp->bcijh", dyf, xf)
    z = torch.einsum("bchps,bcjhs->bcjhp", D, Bh) * e_last[..., None]
    v = torch.einsum("bcijh,bcihp->bcjhp", s * L, dyf) + z
    dx = dtf[..., None] * v
    ddt = (xf * v).sum(-1)
    P = q * L * dtf[:, :, None, :, :]                     # q_ij L_ij dt_j
    u = torch.einsum("bcihp,bchps->bcihs", dyf, H) * e_cum[..., None]
    dC = torch.einsum("bcijh,bcjhs->bcihs", P, Bh) + u
    dB = torch.einsum("bcijh,bcihs->bcjhs", P, Ch) + torch.einsum(
        "bcjhp,bchps->bcjhs", xf * (e_last * dtf)[..., None], D)
    w = P * s * torch.ones_like(tri).tril(-1)[None, None, :, :, None]
    r = dtf * (xf * z).sum(-1)
    dcum = w.sum(3) - w.sum(2) + (Ch * u).sum(-1) - r
    dcum[:, :, -1] += dlast + r.sum(2)

    # 4. finish
    da = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), 2), (2,))
    ddt = ddt + Af * da
    dA = (dtf * da).sum((0, 1, 2))
    dB = dB.reshape(Bsz, nc, l, g, rep, ds).sum(4)
    dC = dC.reshape(Bsz, nc, l, g, rep, ds).sum(4)
    return (dx.reshape(Bsz, Sp, nh, hd)[:, :S].to(x.dtype),
            ddt.reshape(Bsz, Sp, nh)[:, :S], dA,
            dB.reshape(Bsz, Sp, g, ds)[:, :S].to(Bm.dtype),
            dC.reshape(Bsz, Sp, g, ds)[:, :S].to(Cm.dtype), dH)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int, init_state: Optional[torch.Tensor] = None,
                 d_final: Optional[torch.Tensor] = None):
    """ssd_scan's gradient for the cotangents dy (B, S, nh, hd) in x's
    dtype and d_final (B, nh, hd, ds) f32 or None: returns (dx, ddt, dA,
    dBm, dCm, d_init_state), see ``ssd_scan_bwd_plain``. On the card the
    kernels of csrc/ssd_scan_bwd.cu, every product on the tensor cores
    at f32 accuracy (3xTF32: each operand split into two TF32 values;
    bf16 inputs are exact in TF32), with every sum in a fixed order and
    no atomics, so two calls give the same bits; the forward's contract
    on shapes, dtypes, contiguity and alignment, dy and d_final
    included. On the CPU and meta the plain version."""
    if x.device.type in build.PLAIN_DEVICES:
        return ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, chunk=chunk,
                                  init_state=init_state, d_final=d_final)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: no kernel for {x.device}")
    _check("ssd_scan_bwd", x, dt, A, Bm, Cm, chunk, init_state=init_state,
           d_final=d_final, dy=dy)
    Bsz, S, nh, hd = x.shape
    g, ds = Bm.shape[2], Bm.shape[3]
    l = min(chunk, S)
    nc = -(-S // l)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ddt = torch.empty((Bsz, S, nh), **f32)
    dA = torch.empty((nh,), **f32)
    dBm, dCm = torch.empty_like(Bm), torch.empty_like(Cm)
    dinit = torch.empty((Bsz, nh, hd, ds), **f32)
    # f32 scratch: cum, the two halves of its cotangent (row and column
    # sums) and r_j per position; the chunks' own states (the entering
    # states written over them) and G_c (D_c written over it); per chunk
    # <D_c, H_c> by slice of 128 state elements (the state pass's warps)
    # and the dA partials; dB and dC per head before the group sums
    cum, dcum_row, dcum_col, rpos = (torch.empty((Bsz, nc, nh, l), **f32)
                                     for _ in range(4))
    hs, gs = (torch.empty((Bsz, nc, nh, hd, ds), **f32) for _ in range(2))
    dlast = torch.empty((Bsz, nc, nh, hd * ds // _STATE_SLICE), **f32)
    dA_part = torch.empty((Bsz, nc, nh), **f32)
    dBh, dCh = (torch.empty((Bsz, S, nh, ds), **f32) for _ in range(2))

    ptrs = [None if t is None else t.data_ptr() for t in (
        x, dt, A, Bm, Cm, init_state, dy, d_final, dx, ddt, dA, dBm, dCm,
        dinit, cum, hs, gs, dlast, dcum_row, dcum_col, rpos, dA_part, dBh,
        dCh)]
    build.check(build.lib().ssd_scan_bwd(
        *ptrs, Bsz, S, nh, hd, g, ds, l, build.dtype_code(x),
        build.stream_ptr(x.device)), "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dBm, dCm, dinit


ssd_scan_bwd.launches = 0
