"""The plain reference: gpt-paper's decoder and t5-paper's encoder-decoder
trained by AdamW, in plain PyTorch and float32 (TF32 off).

It imports nothing of the program. It follows the port's model as the
configuration states it, which departs from the published models in
these ways, all of them the port's choices: RMSNorm scaling by ``1 + w``;
RoPE (rotated halves) in every self-attention, none in cross-attention;
no biases; the T5 decoder layer runs self-attention, then its MLP, then
cross-attention to the final encoder output; T5's head is the tied
embedding; the GPT's is its own. The loss is the token-mean softmax
cross-entropy of each sample's next tokens over the global batch, the
padded vocabulary rows left out.

Each sample is computed alone in attention (its own causal, bidirectional
or cross pairs), and position-wise work runs on the tokens of a chunk of
whole samples at once, at most ``chunk_tokens`` a chunk, so that it fits
beside the optimizer state. The gradient sums over the chunks.

``precision="fp8"`` is the control: every weight product takes its
operands rounded to float8 (e4m3 forward, e5m2 for the gradients of the
backward, one scale a tensor), the step a later change might take below
the configuration's bfloat16.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.weights import leaf_items

F8_FWD, F8_BWD = torch.float8_e4m3fn, torch.float8_e5m2


def _q8(x, dt):
    """``x`` rounded to the float8 type ``dt`` under one scale, back in
    float32."""
    amax = x.abs().max().clamp(min=1e-30)
    scale = amax / torch.finfo(dt).max
    return (x / scale).to(dt).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q8(a, F8_FWD), _q8(b, F8_FWD)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _q8(g, F8_BWD)
        return qg @ qb.T, qa.T @ qg


def _matmul(precision: str):
    if precision == "fp32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def _rope(x, pos, theta):
    """x (N, H, D), pos (N,): each half-pair rotated by pos x theta^(-i/half)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[:, None, None] * freqs
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def _attend(q, k, v, causal: bool):
    """One sample: q (T, H, D), k and v (S, KV, D)."""
    h, kv = q.shape[1], k.shape[1]
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=1)
        v = v.repeat_interleave(h // kv, dim=1)
    s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(q.shape[-1])
    if causal:
        t = q.shape[0]
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool, device=s.device)
                          .triu(1), float("-inf"))
    return torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1), v)


class _Net:
    def __init__(self, P, model, precision):
        self.P, self.m = P, model
        self.mm = _matmul(precision)
        self.eps = float(model.get("norm_eps", 1e-6))
        self.act = {"gelu": lambda x: F.gelu(x, approximate="tanh"),
                    "relu": F.relu}[model["act"]]

    def heads(self, x, w, n):
        return self.mm(x, w).view(x.shape[0], n, self.m["d_head"])

    def self_attention(self, pre, l, x, pos, lens, causal):
        P, m = self.P, self.m
        h = _rms(x, P[f"{pre}.ln1"][l], self.eps)
        q = _rope(self.heads(h, P[f"{pre}.mixer.wq"][l], m["n_heads"]), pos,
                  m["rope_theta"])
        k = _rope(self.heads(h, P[f"{pre}.mixer.wk"][l], m["n_kv_heads"]),
                  pos, m["rope_theta"])
        v = self.heads(h, P[f"{pre}.mixer.wv"][l], m["n_kv_heads"])
        o, s = [], 0
        for n in lens:
            o.append(_attend(q[s:s + n], k[s:s + n], v[s:s + n], causal))
            s += n
        o = torch.cat(o).reshape(x.shape[0], -1)
        return self.mm(o, P[f"{pre}.mixer.wo"][l])

    def mlp(self, pre, l, x):
        P = self.P
        h = _rms(x, P[f"{pre}.ln2"][l], self.eps)
        return self.mm(self.act(self.mm(h, P[f"{pre}.ffn.w_in"][l])),
                       P[f"{pre}.ffn.w_out"][l])

    def cross_attention(self, l, x, he, dec_lens, enc_lens):
        P, m = self.P, self.m
        h = _rms(x, P["cross.ln"][l], self.eps)
        q = self.heads(h, P["cross.attn.wq"][l], m["n_heads"])
        k = self.heads(he, P["cross.attn.wk"][l], m["n_kv_heads"])
        v = self.heads(he, P["cross.attn.wv"][l], m["n_kv_heads"])
        o, sd, se = [], 0, 0
        for nd, ne in zip(dec_lens, enc_lens):
            o.append(_attend(q[sd:sd + nd], k[se:se + ne], v[se:se + ne],
                             False))
            sd, se = sd + nd, se + ne
        o = torch.cat(o).reshape(x.shape[0], -1)
        return self.mm(o, P["cross.attn.wo"][l])

    def xent(self, x, head, ids, lens):
        """(loss sum, label count): every position but each sample's last
        predicts the next token."""
        vocab = self.m["vocab"]
        logits = self.mm(x, head[:vocab].T)
        starts = np.cumsum([0] + list(lens[:-1]))
        rows = np.concatenate([np.arange(s, s + n - 1)
                               for s, n in zip(starts, lens)])
        rows_t = torch.as_tensor(rows, device=x.device)
        lab = ids[rows_t + 1]
        lg = logits[rows_t]
        ll = torch.logsumexp(lg, dim=-1) - lg.gather(1, lab[:, None])[:, 0]
        return ll.sum(), len(rows)


def _positions(lens, device):
    return torch.cat([torch.arange(n, device=device) for n in lens])


def decoder_loss(P, model, samples, precision="fp32"):
    """gpt-paper: the summed loss and label count of ``samples`` (token
    arrays)."""
    net = _Net(P, model, precision)
    dev = P["embed"].device
    lens = [len(t) for t in samples]
    ids = torch.as_tensor(np.concatenate(samples), device=dev).long()
    pos = _positions(lens, dev)
    x = P["embed"][ids]
    for l in range(model["n_layers"]):
        x = x + net.self_attention("stack.l0", l, x, pos, lens, True)
        x = x + net.mlp("stack.l0", l, x)
    x = _rms(x, P["final_norm"], net.eps)
    return net.xent(x, P.get("head", P["embed"]), ids, lens)


def encdec_loss(P, model, samples, precision="fp32"):
    """t5-paper: ``samples`` are ``(enc tokens, dec tokens)`` pairs; the
    loss is the decoder's."""
    net = _Net(P, model, precision)
    dev = P["embed"].device
    el = [len(e) for e, _ in samples]
    dl = [len(d) for _, d in samples]
    eids = torch.as_tensor(np.concatenate([e for e, _ in samples]),
                           device=dev).long()
    dids = torch.as_tensor(np.concatenate([d for _, d in samples]),
                           device=dev).long()
    epos, dpos = _positions(el, dev), _positions(dl, dev)
    x = P["embed"][eids]
    for l in range(model["n_layers"]):
        x = x + net.self_attention("enc.l0", l, x, epos, el, False)
        x = x + net.mlp("enc.l0", l, x)
    he = _rms(x, P["enc_norm"], net.eps)
    x = P["embed"][dids]
    for l in range(model["n_layers"]):
        x = x + net.self_attention("dec.l0", l, x, dpos, dl, True)
        x = x + net.mlp("dec.l0", l, x)
        x = x + net.cross_attention(l, x, he, dl, el)
    x = _rms(x, P["dec_norm"], net.eps)
    return net.xent(x, P["embed"], dids, dl)


def split_samples(model, gb):
    """A global batch's samples as the loss functions take them."""
    if model["family"] == "encdec":
        return [(t[:int(e)], t[int(e):int(e) + int(d)])
                for t, (e, d) in zip(gb.tokens, gb.lengths)]
    return list(gb.tokens)


def _chunks(samples, size_of, limit):
    out, cur, n = [], [], 0
    for s in samples:
        if cur and n + size_of(s) > limit:
            out.append(cur)
            cur, n = [], 0
        cur.append(s)
        n += size_of(s)
    if cur:
        out.append(cur)
    return out


def train_steps(model, init, batches, opt, *, precision="fp32",
                chunk_tokens=2048):
    """AdamW from ``init`` (the harness's weights, any dtype) over
    ``batches``. Returns ``{"loss": [per step], "grad": {leaf: norm of the
    first step's gradient as the optimizer gets it, before clipping},
    "grad_norm": the first step's global norm, "change": {leaf: norm of the
    master weights' change after the last step}}``."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _train_steps(model, init, batches, opt, precision,
                            chunk_tokens)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _train_steps(model, init, batches, opt, precision, chunk_tokens):
    flat = dict(leaf_items(init))
    P = {k: v.detach().float().clone().requires_grad_() for k, v in
         flat.items()}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    encdec = model["family"] == "encdec"
    loss_of = encdec_loss if encdec else decoder_loss
    size_of = (lambda s: len(s[0]) + len(s[1])) if encdec else len
    out = {"loss": [], "grad": {}, "change": {}}
    b1, b2, lr = opt["b1"], opt["b2"], opt["lr"]
    for step, gb in enumerate(batches, 1):
        loss_sum, n_lab = 0.0, 0
        for chunk in _chunks(split_samples(model, gb), size_of,
                             chunk_tokens):
            ls, n = loss_of(P, model, chunk, precision)
            ls.backward()
            loss_sum += float(ls.detach())
            n_lab += n
        w = float(max(n_lab, 1))
        with torch.no_grad():
            g = {k: p.grad.div_(w) for k, p in P.items()}
            gnorm = math.sqrt(sum(float(x.double().square().sum())
                                  for x in g.values()))
            if step == 1:
                out["grad"] = {k: float(torch.linalg.vector_norm(x))
                               for k, x in g.items()}
                out["grad_norm"] = gnorm
            scale = min(opt["clip_norm"] / max(gnorm, 1e-12), 1.0)
            b1c, b2c = 1.0 - b1 ** step, 1.0 - b2 ** step
            for k, p in P.items():
                gs = g[k].mul_(scale)
                m[k].mul_(b1).add_(gs, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(gs, gs, value=1 - b2)
                upd = (m[k] / b1c) / (torch.sqrt(v2[k] / b2c) + opt["eps"])
                p.sub_(lr * (upd + opt["weight_decay"] * p))
                p.grad = None
        out["loss"].append(loss_sum / w)
    with torch.no_grad():
        out["change"] = {k: float(torch.linalg.vector_norm(
            P[k] - flat[k].float())) for k in P}
    return out
