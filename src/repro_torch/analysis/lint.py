"""IR lint over ExecutionPlan instruction streams.

Rules are derived from what ``core/executor.py`` actually does with each
op — every ERROR here corresponds to a concrete runtime failure (a
KeyError in a stage callback path, a ``DeadlockError``, a silently wrong
result) or to a violation of the §6 construction the planner guarantees.

Rule table (see docs/architecture.md §11):

  invalid-peer           comm op whose peer is out of range / non-adjacent
  wrong-direction        act not flowing j->j+1 or grad not j+1->j
  unknown-micro-batch    op references an mb_id with no MicroBatchSpec
  duplicate-forward/-backward   same compute op twice on one stage
  backward-before-forward       B(mb) with no earlier F(mb) on the stage
  forward-before-wait    stage>0 F(mb) not fenced by WAIT_RECV_ACT(mb)
  backward-before-wait   stage<last B(mb) not fenced by WAIT_RECV_GRAD(mb)
  double-send            same (kind, mb) sent twice from one stage — the
                         second send pops an already-consumed buffer
                         (use-after-send of the activation)
  send-without-producer  send whose payload no F/B on the stage produces
  send-before-producer   producer exists but later in the stream (works —
                         the comm thread blocks — but is non-canonical)
  duplicate-recv / duplicate-wait / wait-without-recv / wait-before-recv
  recv-without-wait      received buffer is never consumed by a WAIT
  missing-opt / multiple-opt / instr-after-opt
  unmatched-send / unmatched-recv   no conjugate Start on the peer stage
  channel-order-mismatch per-directed-channel tag order differs between
                         the two endpoints (head-of-line deadlock)
  pair-order-mismatch    the §6 per-device-pair interleaved order differs
                         (check_order_consistency equivalent)
  shape-mismatch         conjugate send/recv disagree on the tensor shape
  shape-vs-spec          comm shape contradicts the MicroBatchSpec
  palette-violation      spec's (mbs, seq) not on the shape palette
  injection-order-mismatch   meta["injection_order"] disagrees with the
                         stage-0 FORWARD stream order

Recompute awareness: under ``RecomputePolicy.FULL`` (the executor's
policy) the only stashed per-micro-batch state is the stage input, so a
*second* F(mb) is flagged as duplicate rather than treated as a legal
recompute — the executor's backward recomputes internally via ``vjp``
and a literal duplicate F would double-send downstream.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Optional

from repro_torch.core.instructions import (
    RECV_OPS,
    SEND_OPS,
    WAIT_OPS,
    ExecutionPlan,
    Op,
)
from repro_torch.core.shapes import ShapePalette

from repro_torch.analysis.report import Finding, Severity

_KIND = {
    Op.SEND_ACT_START: "act", Op.RECV_ACT_START: "act",
    Op.WAIT_RECV_ACT: "act",
    Op.SEND_GRAD_START: "grad", Op.RECV_GRAD_START: "grad",
    Op.WAIT_RECV_GRAD: "grad",
}


def _seq_total(seq) -> int:
    if isinstance(seq, (tuple, list)):
        return int(seq[0]) + int(seq[1])
    return int(seq)


def lint_plan(plan: ExecutionPlan,
              palette: Optional[ShapePalette] = None) -> list[Finding]:
    out: list[Finding] = []

    def err(rule, msg, **kw):
        out.append(Finding(rule, Severity.ERROR, msg, **kw))

    def warn(rule, msg, **kw):
        out.append(Finding(rule, Severity.WARNING, msg, **kw))

    n = plan.n_stages
    if len(plan.per_stage) != n:
        err("stream-count",
            f"plan declares {n} stages but carries "
            f"{len(plan.per_stage)} streams")
        return out

    specs = {m.mb_id: m for m in plan.micro_batches}

    # comm registries for the cross-stage passes
    # directed channel (src, dst) -> [(tag, shape, stage, idx)]
    ch_sends: dict[tuple[int, int], list] = defaultdict(list)
    ch_recvs: dict[tuple[int, int], list] = defaultdict(list)

    for j, stream in enumerate(plan.per_stage):
        f_at: dict[int, int] = {}
        b_at: dict[int, int] = {}
        sent: dict[tuple, int] = {}
        recv_at: dict[tuple, int] = {}
        waited: dict[tuple, int] = {}
        opt_idx: Optional[int] = None
        for idx, ins in enumerate(stream):
            mb = ins.micro_batch
            kw = {"stage": j, "index": idx, "micro_batch": mb}
            if ins.op in _KIND:
                if mb not in specs:
                    err("unknown-micro-batch",
                        f"{ins.short()}: no MicroBatchSpec for mb {mb}",
                        **kw)
                if ins.op not in WAIT_OPS and abs(ins.peer - j) != 1:
                    err("invalid-peer",
                        f"{ins.short()}: peer {ins.peer} is not an "
                        f"adjacent stage of {j} (no channel exists)", **kw)
                elif ins.op not in WAIT_OPS:
                    kind = _KIND[ins.op]
                    want = {
                        Op.SEND_ACT_START: j + 1, Op.RECV_ACT_START: j - 1,
                        Op.SEND_GRAD_START: j - 1, Op.RECV_GRAD_START: j + 1,
                    }[ins.op]
                    if ins.peer != want:
                        err("wrong-direction",
                            f"{ins.short()}: {kind}s flow "
                            f"{'downstream' if kind == 'act' else 'upstream'}"
                            f"; expected peer {want}", **kw)
            if ins.op is Op.FORWARD:
                if mb in f_at:
                    err("duplicate-forward",
                        f"F{mb} appears twice (earlier at #{f_at[mb]}); "
                        "under recompute=full the executor re-runs the "
                        "forward internally — a literal duplicate "
                        "double-sends the activation", **kw)
                else:
                    f_at[mb] = idx
                if j > 0 and ("act", mb) not in waited:
                    err("forward-before-wait",
                        f"F{mb} consumes a received activation but no "
                        f"WAIT_RECV_ACT({mb}) precedes it", **kw)
            elif ins.op is Op.BACKWARD:
                if mb in b_at:
                    err("duplicate-backward",
                        f"B{mb} appears twice (earlier at #{b_at[mb]}); "
                        "gradients would be accumulated twice and the "
                        "recompute stash is already consumed", **kw)
                else:
                    b_at[mb] = idx
                if mb not in f_at:
                    err("backward-before-forward",
                        f"B{mb} has no earlier F{mb} on this stage", **kw)
                if j + 1 < n and ("grad", mb) not in waited:
                    err("backward-before-wait",
                        f"B{mb} consumes a received gradient but no "
                        f"WAIT_RECV_GRAD({mb}) precedes it", **kw)
            elif ins.op in SEND_OPS:
                kind = _KIND[ins.op]
                key = (kind, mb)
                if key in sent:
                    err("double-send",
                        f"{ins.short()}: ({kind}, {mb}) already sent at "
                        f"#{sent[key]} — the buffer was consumed by that "
                        "send (use-after-send)", **kw)
                else:
                    sent[key] = idx
                producer = f_at if kind == "act" else b_at
                # the payload only exists if the producing compute op both
                # runs and stores it (last stage stores no act, stage 0
                # stores no grad)
                stores = (j + 1 < n) if kind == "act" else (j > 0)
                if mb not in producer or not stores:
                    later = any(
                        o.op is (Op.FORWARD if kind == "act"
                                 else Op.BACKWARD)
                        and o.micro_batch == mb
                        for o in stream[idx + 1:])
                    if later and stores:
                        warn("send-before-producer",
                             f"{ins.short()}: producing "
                             f"{'F' if kind == 'act' else 'B'}{mb} appears "
                             "later in the stream (legal — the comm "
                             "thread blocks — but non-canonical)", **kw)
                    else:
                        err("send-without-producer",
                            f"{ins.short()}: no compute op on stage {j} "
                            f"ever stores the ({kind}, {mb}) payload",
                            **kw)
                ch_sends[(j, ins.peer)].append((key, ins.shape, j, idx))
            elif ins.op in RECV_OPS:
                kind = _KIND[ins.op]
                key = (kind, mb)
                if key in recv_at:
                    err("duplicate-recv",
                        f"{ins.short()}: ({kind}, {mb}) already received "
                        f"at #{recv_at[key]}", **kw)
                else:
                    recv_at[key] = idx
                ch_recvs[(ins.peer, j)].append((key, ins.shape, j, idx))
            elif ins.op in WAIT_OPS:
                kind = _KIND[ins.op]
                key = (kind, mb)
                if key in waited:
                    err("duplicate-wait",
                        f"{ins.short()}: ({kind}, {mb}) already waited "
                        f"at #{waited[key]}", **kw)
                else:
                    waited[key] = idx
                if key not in recv_at:
                    later = any(o.op in RECV_OPS
                                and _KIND[o.op] == kind
                                and o.micro_batch == mb
                                for o in stream[idx + 1:])
                    if later:
                        err("wait-before-recv",
                            f"{ins.short()}: the matching recv Start is "
                            "issued *after* this wait — the compute "
                            "thread blocks before it can enqueue the "
                            "recv (self-deadlock)", **kw)
                    else:
                        err("wait-without-recv",
                            f"{ins.short()}: no RECV Start for "
                            f"({kind}, {mb}) on this stage", **kw)
            elif ins.op is Op.REDUCE_AND_STEP:
                if opt_idx is not None:
                    err("multiple-opt",
                        f"second REDUCE_AND_STEP (earlier at #{opt_idx})",
                        **kw)
                else:
                    opt_idx = idx
        if stream and opt_idx is None:
            err("missing-opt",
                "stream has compute/comm ops but no REDUCE_AND_STEP — "
                "the optimizer never runs on this stage", stage=j)
        if opt_idx is not None and opt_idx != len(stream) - 1:
            warn("instr-after-opt",
                 f"{len(stream) - 1 - opt_idx} instruction(s) after "
                 "REDUCE_AND_STEP", stage=j, index=opt_idx)
        for key, ridx in recv_at.items():
            if key not in waited:
                err("recv-without-wait",
                    f"received ({key[0]}, {key[1]}) is never consumed by "
                    "a WAIT — the consuming compute op would pop a "
                    "missing buffer", stage=j, index=ridx,
                    micro_batch=key[1])

    # ---------------- cross-stage: conjugate pairing & §6 order ----------
    for ch in sorted(set(ch_sends) | set(ch_recvs)):
        src, dst = ch
        s_list = ch_sends.get(ch, [])
        r_list = ch_recvs.get(ch, [])
        r_by_tag: dict[tuple, list] = defaultdict(list)
        for ent in r_list:
            r_by_tag[ent[0]].append(ent)
        for tag, shape, j, idx in s_list:
            if r_by_tag[tag]:
                _rt, r_shape, rj, ridx = r_by_tag[tag].pop(0)
                if shape != r_shape:
                    err("shape-mismatch",
                        f"channel {src}->{dst} {tag}: send shape "
                        f"{shape} != recv shape {r_shape}",
                        stage=j, index=idx, micro_batch=tag[1])
            else:
                err("unmatched-send",
                    f"channel {src}->{dst}: send {tag} has no conjugate "
                    f"recv on stage {dst}", stage=j, index=idx,
                    micro_batch=tag[1])
        for rest in r_by_tag.values():
            for tag, _shape, rj, ridx in rest:
                err("unmatched-recv",
                    f"channel {src}->{dst}: recv {tag} has no conjugate "
                    f"send on stage {src}", stage=rj, index=ridx,
                    micro_batch=tag[1])
        # in-order channel: both endpoints must name the same tag sequence
        s_tags = [e[0] for e in s_list]
        r_tags = [e[0] for e in r_list]
        if (sorted(s_tags) == sorted(r_tags) and s_tags != r_tags):
            k = next(i for i, (a, b) in enumerate(zip(s_tags, r_tags))
                     if a != b)
            err("channel-order-mismatch",
                f"channel {src}->{dst}: position {k} posts {s_tags[k]} "
                f"but the receiver expects {r_tags[k]} — head-of-line "
                "deadlock on an in-order channel", stage=dst,
                index=r_list[k][3], micro_batch=r_tags[k][1])

    # §6 per-device-pair interleaved order (both directions zipped), the
    # check_order_consistency property as severity-leveled findings
    pair_order: dict[tuple[int, int], list] = defaultdict(list)
    for j, stream in enumerate(plan.per_stage):
        for idx, ins in enumerate(stream):
            if ins.op in SEND_OPS:
                pair_order[(j, ins.peer)].append(("S", _KIND[ins.op],
                                                  ins.micro_batch, idx))
            elif ins.op in RECV_OPS:
                pair_order[(j, ins.peer)].append(("R", _KIND[ins.op],
                                                  ins.micro_batch, idx))
    seen = set()
    for (a, b) in sorted(pair_order):
        if (b, a) in seen:
            continue
        seen.add((a, b))
        mine = pair_order[(a, b)]
        theirs = pair_order.get((b, a), [])
        if len(mine) != len(theirs):
            err("pair-order-mismatch",
                f"pair ({a},{b}): {len(mine)} comm ops on stage {a} vs "
                f"{len(theirs)} on stage {b}", stage=a)
            continue
        for x, y in zip(mine, theirs):
            if x[0] == y[0] or x[1] != y[1] or x[2] != y[2]:
                err("pair-order-mismatch",
                    f"pair ({a},{b}): {x[0]}({x[1]},{x[2]}) on stage {a} "
                    f"faces {y[0]}({y[1]},{y[2]}) on stage {b} — the §6 "
                    "co-scheduled order is broken", stage=a, index=x[3],
                    micro_batch=x[2])
                break

    # ---------------- shapes vs specs & palette conformance --------------
    for j, stream in enumerate(plan.per_stage):
        for idx, ins in enumerate(stream):
            if ins.op in SEND_OPS or ins.op in RECV_OPS:
                m = specs.get(ins.micro_batch)
                if m is None or ins.shape is None:
                    continue
                want = (int(m.mbs), _seq_total(m.seq))
                got = tuple(int(x) for x in ins.shape[:2])
                if got != want:
                    err("shape-vs-spec",
                        f"{ins.short()}: shape {tuple(ins.shape)} "
                        f"contradicts spec (mbs={want[0]}, "
                        f"seq_total={want[1]})", stage=j, index=idx,
                        micro_batch=ins.micro_batch)
    if palette is not None:
        for m in plan.micro_batches:
            if int(m.mbs) not in palette.mbs_buckets:
                err("palette-violation",
                    f"mb {m.mb_id}: mbs={m.mbs} is not a palette bucket "
                    f"{palette.mbs_buckets}", micro_batch=m.mb_id)
            seqs = m.seq if isinstance(m.seq, (tuple, list)) else (m.seq,)
            for s in seqs:
                if int(s) != 0 and int(s) not in palette.seq_buckets:
                    err("palette-violation",
                        f"mb {m.mb_id}: seq={s} is not a palette bucket",
                        micro_batch=m.mb_id)

    # ---------------- injection order ------------------------------------
    inj = plan.meta.get("injection_order")
    if inj is not None and plan.per_stage:
        declared = [int(i) for i in inj]
        actual = [ins.micro_batch for ins in plan.per_stage[0]
                  if ins.op is Op.FORWARD]
        if sorted(declared) != sorted(actual):
            err("injection-order-mismatch",
                f"meta injection_order {declared} does not cover the "
                f"stage-0 FORWARD set {sorted(actual)} — mesh/pipelined "
                "backends inject in meta order and would drop or "
                "duplicate micro-batches", stage=0)
        elif declared != actual:
            # build_instructions breaks time ties by global sequence
            # number, which may legally diverge from the schedule's
            # permutation on *tied* launch times (dist/pipeline.py) — so
            # a pure reordering is suspicious, not provably wrong
            warn("injection-order-mismatch",
                 f"meta injection_order {declared} reorders the stage-0 "
                 f"FORWARD stream {actual} (legal only for tied launch "
                 "times)", stage=0)
    return out
