"""Batched serving with dynamic request batching, in PyTorch.

Counterpart of ``examples/serve_batched.py``: the DynaPipe idea applied to
inference. Variable-length requests are ordered and grouped into bucketed
prefill batches by the same DP splitter that builds training micro-batches
(``order_samples`` + ``dp_split`` over a ``ShapePalette``, with a
forward-only cost). Each batch is prefilled into a KV cache with headroom
and then decoded greedily in lockstep for a few tokens. On the card,
attention goes through the CUDA kernel K1 and a Mamba2 prefill's SSD
through K4; a Mamba2 decode step is plain PyTorch, as in the reference.

    python -m repro_torch.serve                       # reduced gpt-paper, 2 layers
    python -m repro_torch.serve --width full --n-layers 32 --max-prompt 2048 \\
        --n-requests 32 --decode-steps 16
    python -m repro_torch.serve --arch mamba2-130m --width full --n-layers 24 \\
        --max-prompt 2048 --n-requests 32 --decode-steps 16

As in the reference example, a batch's logits come from its last column, so
a prompt shorter than its batch's padded length takes its first greedy
token from a pad position.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, get_arch, reduced
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.microbatch import (MicroBatch, dp_split, order_samples,
                                         padding_efficiency)
from repro_torch.core.shapes import ShapePalette
from repro_torch.data.synthetic import MultiTaskDataset
from repro_torch.device import resolve_device
from repro_torch.models import model as MD

MAX_PROMPT = 256
DECODE_STEPS = 8
N_REQUESTS = 24
N_TASKS = 16
DATA_SEED = 3


class PrefillCost(AnalyticCostModel):
    """Serving cost: prefill is forward-only, memory is the KV cache."""

    def stage_bwd_time(self, mbs, seq, tp=1):
        return 0.0

    def stage_act_memory(self, mbs, seq, tp=1):
        s = seq if not isinstance(seq, tuple) else sum(seq)
        kv = 2 * self.cfg.n_kv_heads * self.cfg.d_head * self.cfg.n_layers
        return float(mbs * s * kv * 2)


def plan_batches(cfg: ArchConfig, prompt_lens: np.ndarray, max_prompt: int):
    """Order the requests and split them into prefill batches.
    Returns ``(order, batches)``; batch indices point into ``order``."""
    pal = ShapePalette.build(min_seq=32, max_seq=max_prompt, seq_align=32,
                             max_mbs=16)
    cost = PrefillCost(cfg, n_stages=1)
    order = order_samples(prompt_lens)
    batches = dp_split(prompt_lens[order], cost, 1, palette=pal,
                       mem_limit=1e12)
    return order, batches


def batch_arrays(mb: MicroBatch, tokens, order):
    """(mbs, seq) int32 tokens and positions of one prefill batch; rows and
    columns past the prompts are token 0 at position 0."""
    b, s = mb.mbs, mb.seq
    tok = np.zeros((b, s), np.int32)
    pos = np.zeros((b, s), np.int32)
    for row, idx in enumerate(mb.indices):
        t = tokens[order[idx]][:s]
        tok[row, : len(t)] = t
        pos[row, : len(t)] = np.arange(len(t))
    return tok, pos


@dataclasses.dataclass
class ServeResult:
    order: np.ndarray
    batches: list
    padding_efficiency: float
    prompt_tokens: int          # real prompt tokens prefilled
    padded_tokens: int          # tokens of the padded prefill batches
    decode_tokens: int          # requests x decode steps
    prefill_s: float
    decode_s: float
    tokens: list                # per batch: (mbs, steps + 1) greedy ids
    logits: list                # per batch: (steps + 1, mbs, Vp) fp32

    @property
    def prefill_tok_s(self) -> float:
        return self.prompt_tokens / self.prefill_s

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / self.decode_s


def serve(params, cfg: ArchConfig, tokens, *, max_prompt=MAX_PROMPT,
          decode_steps=DECODE_STEPS, log=None) -> ServeResult:
    """Serve the prompts ``tokens`` (a list of int arrays) on the device of
    ``params``: DP batching, then prefill + ``decode_steps`` greedy steps
    per batch. Times are host time around work that ends in a device
    synchronise."""
    device = params["embed"].device
    prompt_lens = np.array([len(t) for t in tokens], np.int64)
    order, batches = plan_batches(cfg, prompt_lens, max_prompt)
    eff = padding_efficiency(batches, prompt_lens[order])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out_tokens, out_logits = [], []
    prefill_s = decode_s = 0.0
    done = 0
    with torch.inference_mode():
        for mb in batches:
            tok, pos = batch_arrays(mb, tokens, order)
            b, s = tok.shape
            batch = {"tokens": torch.from_numpy(tok).to(device),
                     "positions": torch.from_numpy(pos).to(device)}
            sync()
            t0 = time.perf_counter()
            logits, cache = MD.prefill(params, batch, cfg,
                                       cache_len=s + decode_steps)
            nxt = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            sync()
            t1 = time.perf_counter()
            steps_logits, steps_tokens = [logits], [nxt]
            for step in range(decode_steps):
                pos_d = torch.full((b, 1), s + step, dtype=torch.int32,
                                   device=device)
                logits, cache = MD.decode(params, {
                    "tokens": nxt, "positions": pos_d, "cache": cache,
                    "cache_pos": s + step}, cfg)
                nxt = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
                steps_logits.append(logits)
                steps_tokens.append(nxt)
            sync()
            t2 = time.perf_counter()
            prefill_s += t1 - t0
            decode_s += t2 - t1
            del cache
            out_logits.append(torch.stack(steps_logits))
            out_tokens.append(torch.cat(steps_tokens, dim=1).cpu().numpy())
            done += mb.n_samples
            if log:
                log(f"  batch ({b:3d} x {s:4d}): prefill {t1 - t0:.3f}s + "
                    f"{decode_steps} decode steps {t2 - t1:.3f}s  "
                    f"({done}/{len(tokens)} requests)")
    return ServeResult(
        order=order, batches=batches, padding_efficiency=eff,
        prompt_tokens=int(prompt_lens.sum()),
        padded_tokens=int(sum(mb.padded_tokens for mb in batches)),
        decode_tokens=len(tokens) * decode_steps,
        prefill_s=prefill_s, decode_s=decode_s,
        tokens=out_tokens, logits=out_logits)


def make_config(arch: str, width: str, n_layers: int) -> ArchConfig:
    cfg = get_arch(arch)
    if width == "reduced":
        cfg = reduced(cfg)
    return dataclasses.replace(cfg, n_layers=n_layers)


def make_requests(cfg: ArchConfig, n_requests: int, max_prompt: int):
    """Prompts from the reference's synthetic multi-task mix."""
    ds = MultiTaskDataset(n_tasks=N_TASKS, max_len=max_prompt, seed=DATA_SEED)
    _, tokens, _ = ds.sample_minibatch(n_requests, cfg.vocab)
    return tokens


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gpt-paper")
    ap.add_argument("--width", choices=("reduced", "full"), default="reduced",
                    help="reduced: the reference's CPU smoke widths")
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--max-prompt", type=int, default=MAX_PROMPT)
    ap.add_argument("--n-requests", type=int, default=N_REQUESTS)
    ap.add_argument("--decode-steps", type=int, default=DECODE_STEPS)
    ap.add_argument("--seed", type=int, default=0, help="weights' seed")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = make_config(args.arch, args.width, args.n_layers)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = MD.init_params(gen, cfg, device=device)
    tokens = make_requests(cfg, args.n_requests, args.max_prompt)
    lens = np.array([len(t) for t in tokens])
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_params() / 1e9:.2f} B params on {device}")
    print(f"{len(tokens)} requests, prompt lengths min={lens.min()} "
          f"p50={int(np.median(lens))} max={lens.max()}")
    res = serve(params, cfg, tokens, max_prompt=args.max_prompt,
                decode_steps=args.decode_steps, log=print)
    print(report(res, lens))
    return res


def report(res: ServeResult, lens) -> str:
    split = " ".join(f"{mb.n_samples}/{mb.mbs}x{mb.seq}" for mb in res.batches)
    return (
        f"DP request batching -> {len(res.batches)} prefill batches "
        f"[requests/rows x seq: {split}], padding efficiency "
        f"{res.padding_efficiency:.1%} (pad-to-max would be "
        f"{lens.sum() / (lens.max() * len(lens)):.1%})\n"
        f"prefill: {res.prompt_tokens} prompt tokens "
        f"({res.padded_tokens} padded) in {res.prefill_s:.3f}s = "
        f"{res.prefill_tok_s:.1f} tok/s\n"
        f"decode: {res.decode_tokens} tokens in {res.decode_s:.3f}s = "
        f"{res.decode_tok_s:.1f} tok/s")


if __name__ == "__main__":
    main()
