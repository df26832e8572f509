"""The plain reference of a served MoE decoder, in float32 (or, as the
control, with every matrix product's operands rounded to float8 e4m3).

It reads only the weights the benchmark drew and what was served: each
request's prompt and tokens, and which decode step computed each token.
From those it works out again everything the program derived: the
cache (as full causal attention over each sequence), the router's
gates, the policy's selection (per decode step for Algorithm 2, whose
set depends on the whole batch), the routed experts, the shared expert
and the head. A prompt is routed per token with the policy off, as the
program prefills; a decode token under the batch policy is routed
within its step's selected set.

Layers go one at a time over every token of every sequence given; the
residual stream of all of them is held, everything else is made a
sequence, a block of rows or an expert at a time. Weights are read in
their stored dtype and widened a block at a time. Imports torch alone.

Architecture, as the configuration file states it: token embedding;
per layer, pre-norm RMSNorm, GQA attention (with ``qk_norm``, an
RMSNorm over each head's q and k) with half-split rotary position
embedding (theta from the file), scaled by 1/sqrt(head_dim),
and a residual add; pre-norm RMSNorm, a softmax router over the routed
experts, top-k (weights a softmax over the chosen logits when
norm_topk_prob), SwiGLU experts, the shared experts on every token, and
a residual add; a final RMSNorm and the head (the embedding's transpose
when tied).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

ROWS = 8192       # rows of a block where all tokens are processed
MOE_ROWS = 65536  # rows of a block through the experts
Q_CHUNK = 256     # queries a block in attention


@dataclass
class Batch:
    """Every token the reference runs, sequence after sequence.
    ``step[i]`` is the decode step that computed token i's position, -1
    for a prompt position (prefilled). ``need`` marks the positions
    whose logits are wanted."""
    tokens: torch.Tensor      # (N,) int64
    starts: List[int]         # first index of each sequence, then N
    step: torch.Tensor        # (N,) int64
    need: torch.Tensor        # (N,) bool


class Arith:
    """float32 products; the control's, both operands rounded to e4m3
    with a scale per row of the left and per column of the right (the
    usual scaled float8 product); or a witness's, both operands rounded
    to bfloat16, the precision the program serves in. Each accumulates
    in float32."""

    def __init__(self, kind: str):
        if kind not in ("f32", "fp8", "bf16"):
            raise ValueError(kind)
        self.kind = kind

    @staticmethod
    def _q(x: torch.Tensor, dim: int) -> torch.Tensor:
        s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).float() * s

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return a @ b
        if self.kind == "bf16":
            return a.bfloat16().float() @ b.bfloat16().float()
        return self._q(a, -1) @ self._q(b, -2)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding. x (n, h, dh), pos (n,)."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, device=x.device,
                                        dtype=torch.float32) / half))
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sorted_topk(x: torch.Tensor, k: int):
    """The k largest along the last axis, equal values lower index
    first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Reference:
    def __init__(self, cfg: Dict, weights: Dict, policy: Dict, *,
                 arith: str = "f32"):
        self.cfg = cfg
        self.w = weights
        self.policy = policy
        self.ar = Arith(arith)
        self.eps = float(cfg["rms_norm_eps"])
        self.H = cfg["num_attention_heads"]
        self.Hkv = cfg["num_key_value_heads"]
        self.dh = cfg["head_dim"]
        self.k = cfg["num_experts_per_tok"]
        self.E = cfg["n_routed_experts"]
        # per layer, each token's routing margin: how far (in router
        # logits) its last chosen expert lies above the best one it could
        # have had instead; where this is near zero, rounding can swap
        # the choice
        self.margins: List[torch.Tensor] = []

    # ------------------------------------------------------- attention --
    def _attend(self, h: torch.Tensor, pos: torch.Tensor, l: int
                ) -> torch.Tensor:
        """Causal GQA attention of one sequence. h (n, d) normed."""
        a = self.w["layers"]["attn"]
        n = h.shape[0]
        H, Hkv, dh = self.H, self.Hkv, self.dh
        q = self.ar.mm(h, a["wq"][l].float()).reshape(n, H, dh)
        k = self.ar.mm(h, a["wk"][l].float()).reshape(n, Hkv, dh)
        v = self.ar.mm(h, a["wv"][l].float()).reshape(n, Hkv, dh)
        if self.cfg.get("qk_norm"):
            q = rms_norm(q, a["q_norm"][l], self.eps)
            k = rms_norm(k, a["k_norm"][l], self.eps)
        theta = float(self.cfg["rope_theta"])
        q, k = rope(q, pos, theta), rope(k, pos, theta)
        rep = H // Hkv
        kh = k.repeat_interleave(rep, dim=1).permute(1, 2, 0)   # (H, dh, n)
        vh = v.repeat_interleave(rep, dim=1).permute(1, 0, 2)   # (H, n, dh)
        out = torch.empty((n, H, dh), device=h.device)
        col = torch.arange(n, device=h.device)
        for lo in range(0, n, Q_CHUNK):
            qb = q[lo:lo + Q_CHUNK].permute(1, 0, 2)             # (H, c, dh)
            s = self.ar.mm(qb, kh) / math.sqrt(dh)              # (H, c, n)
            row = torch.arange(lo, lo + qb.shape[1], device=h.device)
            s = s.masked_fill(col[None, None, :] > row[None, :, None],
                              -math.inf)
            p = torch.softmax(s, dim=-1)
            out[lo:lo + Q_CHUNK] = self.ar.mm(p, vh).permute(1, 0, 2)
        return self.ar.mm(out.reshape(n, H * dh), a["wo"][l].float())

    # --------------------------------------------------------- routing --
    def _route(self, logits: torch.Tensor, step: torch.Tensor):
        """(idx, weights), each (N, k), for the routing logits (N, E)."""
        k = self.k
        norm = bool(self.cfg["norm_topk_prob"])
        probs = torch.softmax(logits, dim=-1)
        top_l, idx = sorted_topk(logits, k + 1)
        margin = top_l[:, k - 1] - top_l[:, k]
        top_l, idx = top_l[:, :k], idx[:, :k]
        w = torch.softmax(top_l, -1) if norm else torch.gather(probs, -1, idx)
        self.margins.append(margin)
        if self.policy["mode"] == "off":
            return idx, w
        dec = (step >= 0).nonzero()[:, 0]
        if len(dec):
            d_idx, d_w, d_m = self._batch_route(logits[dec], probs[dec],
                                                step[dec])
            idx[dec], w[dec], margin[dec] = d_idx, d_w, d_m
        return idx, w

    def _batch_route(self, logits, probs, step):
        """Algorithm 2 per decode step: each token's top-k0 experts (the
        warm-up union), then the m_l with the most gate mass of the
        step's tokens outside it; each token then takes its top-k within
        the set, weighted by a softmax over those logits."""
        E, k = self.E, self.k
        k0, m = int(self.policy["k0"]), int(self.policy["m_l"])
        steps, inv = torch.unique(step, return_inverse=True)
        S = len(steps)
        warm = torch.zeros((S, E), dtype=torch.bool, device=probs.device)
        if k0 > 0:
            _, top0 = sorted_topk(probs, k0)
            warm[inv[:, None].expand_as(top0), top0] = True
        mass = torch.zeros((S, E), device=probs.device)
        mass.index_add_(0, inv, probs)
        pool = torch.where(warm, -math.inf, mass)
        ranked, pick = sorted_topk(pool, min(m + 1, E))
        edge = torch.full((S,), math.inf, device=probs.device)
        if 0 < m < E:
            # the set's edge: the last expert picked against the first
            # left out, in log gate mass
            a, b = ranked[:, m - 1], ranked[:, m]
            ok = torch.isfinite(a) & torch.isfinite(b)
            edge = torch.where(ok, torch.log(a) - torch.log(b.clamp_min(
                1e-30)), edge)
        pick = pick[:, :m]
        sel = warm.clone()
        if m > 0:
            sel.scatter_(1, pick, True)
        allowed = sel[inv]
        masked = torch.where(allowed, probs, -math.inf)
        top_g, idx = sorted_topk(masked, min(k + 1, E))
        valid = torch.isfinite(top_g)
        lg = torch.where(valid, torch.gather(logits, -1, idx), -math.inf)
        margin = edge[inv]
        if lg.shape[1] > k:
            margin = torch.minimum(margin, torch.nan_to_num(
                lg[:, k - 1] - lg[:, k], nan=math.inf))
        idx, valid, lg = idx[:, :k], valid[:, :k], lg[:, :k]
        w = torch.softmax(lg, dim=-1)
        w = torch.where(valid, w, 0.0)
        return idx, w, margin

    # --------------------------------------------------------- experts --
    def _swiglu(self, x, w1, w3, w2):
        return self.ar.mm(F.silu(self.ar.mm(x, w1)) * self.ar.mm(x, w3), w2)

    def _moe(self, h: torch.Tensor, idx, w, l: int, x: torch.Tensor,
             rows: torch.Tensor) -> None:
        """x[rows] += routed and shared experts of h (len(rows), d)."""
        p = self.w["layers"]["moe"]
        flat_e = idx.reshape(-1)
        flat_w = w.reshape(-1)
        tok = torch.arange(idx.shape[0], device=h.device).repeat_interleave(
            idx.shape[1])
        keep = flat_w != 0
        flat_e, flat_w, tok = flat_e[keep], flat_w[keep], tok[keep]
        order = torch.argsort(flat_e, stable=True)
        flat_e, flat_w, tok = flat_e[order], flat_w[order], tok[order]
        counts = torch.bincount(flat_e, minlength=self.E).tolist()
        lo = 0
        for e, c in enumerate(counts):
            if not c:
                continue
            t = tok[lo:lo + c]
            y = self._swiglu(h[t], p["w1"][l, e].float(), p["w3"][l, e].float(),
                             p["w2"][l, e].float())
            x.index_add_(0, rows[t], y * flat_w[lo:lo + c, None])
            lo += c
        if "ws1" in p:
            ws = (p["ws1"][l].float(), p["ws3"][l].float(), p["ws2"][l].float())
            for b in range(0, h.shape[0], ROWS):
                x[rows[b:b + ROWS]] += self._swiglu(h[b:b + ROWS], *ws)

    # --------------------------------------------------------- forward --
    @torch.no_grad()
    def final_hidden(self, batch: Batch) -> torch.Tensor:
        """The final-normed hidden state of every needed position, in
        the order they appear: (n_need, d) float32."""
        dev = self.w["embed"].device
        L = self.cfg["num_hidden_layers"]
        tokens = batch.tokens.to(dev)
        step = batch.step.to(dev)
        need = batch.need.to(dev)
        x = self.w["embed"][tokens].float()
        N = x.shape[0]
        pos = torch.empty(N, dtype=torch.int64, device=dev)
        for a, b in zip(batch.starts[:-1], batch.starts[1:]):
            pos[a:b] = torch.arange(b - a, device=dev)
        lay = self.w["layers"]
        for l in range(L):
            for a, b in zip(batch.starts[:-1], batch.starts[1:]):
                h = rms_norm(x[a:b], lay["attn_norm"][l], self.eps)
                x[a:b] += self._attend(h, pos[a:b], l)
            wg = lay["moe"]["wg"][l].float()
            logits = torch.empty((N, self.E), device=dev)
            for b in range(0, N, ROWS):
                h = rms_norm(x[b:b + ROWS], lay["moe_norm"][l], self.eps)
                logits[b:b + ROWS] = self.ar.mm(h, wg)
            idx, w = self._route(logits, step)
            del logits
            rows = need.nonzero()[:, 0] if l == L - 1 else \
                torch.arange(N, device=dev)
            for b in range(0, len(rows), MOE_ROWS):
                r = rows[b:b + MOE_ROWS]
                h = rms_norm(x[r], lay["moe_norm"][l], self.eps)
                self._moe(h, idx[r], w[r], l, x, r)
                del h
        out = x[need]
        del x
        return rms_norm(out, self.w["final_norm"], self.eps)

    @torch.no_grad()
    def head_stats(self, hidden: torch.Tensor, targets: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        """Per needed position: the best logit, the argmax, and the logit
        of ``targets`` (n,), over the real vocabulary."""
        V = self.cfg["vocab_size"]
        table = self.w["embed"] if self.cfg["tie_word_embeddings"] \
            else self.w["lm_head"]
        tied = bool(self.cfg["tie_word_embeddings"])
        n = hidden.shape[0]
        best = torch.full((n,), -math.inf, device=hidden.device)
        arg = torch.zeros((n,), dtype=torch.int64, device=hidden.device)
        at = torch.zeros((n,), device=hidden.device)
        targets = targets.to(hidden.device)
        for lo in range(0, V, 32768):
            hi = min(V, lo + 32768)
            wt = (table[lo:hi].float().T if tied else table[:, lo:hi].float())
            for r0 in range(0, n, ROWS):
                r = slice(r0, r0 + ROWS)
                lg = self.ar.mm(hidden[r], wt)               # (rows, c)
                v, i = lg.max(dim=-1)
                better = v > best[r]
                best[r] = torch.where(better, v, best[r])
                arg[r] = torch.where(better, i + lo, arg[r])
                tr = targets[r]
                inside = (tr >= lo) & (tr < hi)
                got = torch.gather(lg, 1, (tr - lo).clamp(0, hi - lo - 1)
                                   [:, None])[:, 0]
                at[r] = torch.where(inside, got, at[r])
        return {"best": best, "argmax": arg, "at_target": at}


def served_batch(seqs: List[Dict], want: Optional[set] = None) -> Batch:
    """The reference's batch from served requests. Each ``seqs`` item
    has ``prompt`` (S,), ``tokens`` (n,) as served, ``steps`` (n,), the
    decode step that produced each token (-1 for the first, which the
    prefill produced), and ``rid``. The sequence run is the prompt and
    every served token but the last; the position that produced token j
    is S - 1 + j, computed at the step that produced token j. Positions
    are needed for the requests in ``want`` (all when None)."""
    toks, steps, need, starts = [], [], [], [0]
    for s in seqs:
        p = torch.as_tensor(s["prompt"], dtype=torch.int64)
        t = torch.as_tensor(s["tokens"], dtype=torch.int64)
        st = torch.as_tensor(s["steps"], dtype=torch.int64)
        S, n = len(p), len(t)
        toks.append(torch.cat([p, t[:-1]]))
        step = torch.full((S + n - 1,), -1, dtype=torch.int64)
        step[S:] = st[1:]
        steps.append(step)
        nd = torch.zeros(S + n - 1, dtype=torch.bool)
        if want is None or s["rid"] in want:
            nd[S - 1:] = True
        need.append(nd)
        starts.append(starts[-1] + S + n - 1)
    return Batch(torch.cat(toks), starts, torch.cat(steps), torch.cat(need))
