"""Mamba2 chunked SSD scan kernel (``csrc/ssd_scan.cu``) and its plain
PyTorch version.

The contract is the JAX package's ``models/ssm.py ssd_chunked``: Bm and
Cm per group (head h reads group h // (nh // g)), an optional initial
state, a ragged last chunk. A CPU or meta tensor goes to the plain
version (on meta it only propagates shapes), a CUDA tensor to the
kernel; ``ssd_scan.launches`` counts the kernel's
calls (one call is the kernel's three passes). The kernel has no
backward: on the card an input that requires grad raises, so an SSM or
hybrid train step fails there instead of losing its gradient (the plain
version keeps its autograd).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

# (head dim, state width) pairs the kernel is built for: mamba2-370m,
# zamba2-1.2b, and both reduced to d_model 128
_SHAPES = ((64, 128), (64, 64), (32, 16))


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
    (B, nh, hd, ds) in f32."""
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
    xf = x.float().reshape(Bsz, nc, l, nh, hd)
    dtf = dt.float().reshape(Bsz, nc, l, nh)
    Bh = Bm.float().reshape(Bsz, nc, l, g, ds).repeat_interleave(rep, dim=3)
    Ch = Cm.float().reshape(Bsz, nc, l, g, ds).repeat_interleave(rep, dim=3)
    dA = dtf * A.float()[None, None, None, :]            # (B,nc,l,nh) <= 0
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
    prev = torch.zeros((Bsz, nh, hd, ds), dtype=torch.float32,
                       device=x.device) if init_state is None \
        else init_state.float()
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
    16-byte aligned (the kernel reads them in 16-byte vectors)."""
    if x.device.type in build.PLAIN_DEVICES:
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk,
                              init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for {x.device}")
    build.refuse_grad("ssd_scan", x, dt, A, Bm, Cm, init_state)
    Bsz, S, nh, hd = x.shape
    g, ds = Bm.shape[2], Bm.shape[3]
    if dt.shape != (Bsz, S, nh) or A.shape != (nh,) or \
            Bm.shape != (Bsz, S, g, ds) or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if S < 1 or chunk < 1 or nh % g or (hd, ds) not in _SHAPES:
        raise ValueError(f"ssd_scan: S={S}, chunk={chunk}, nh={nh}, g={g}, "
                         f"hd={hd}, ds={ds} not supported ((hd, ds) in "
                         f"{_SHAPES}, g | nh)")
    if not (x.dtype == Bm.dtype == Cm.dtype) or \
            dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("ssd_scan: x, Bm, Cm must share a dtype; dt and A "
                         "must be float32")
    tensors = dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm)
    if init_state is not None:
        if init_state.shape != (Bsz, nh, hd, ds) or \
                init_state.dtype != torch.float32:
            raise ValueError("ssd_scan: init_state must be float32 "
                             f"{(Bsz, nh, hd, ds)}")
        tensors["init_state"] = init_state
    for name, t in tensors.items():
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be a contiguous "
                             f"tensor on {x.device}")
        if name not in ("dt", "A") and t.data_ptr() % 16:
            raise ValueError(f"ssd_scan: {name} not 16-byte aligned")
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
