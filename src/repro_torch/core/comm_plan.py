"""Deadlock-free communication planning (paper §6).

Given a pipeline schedule, we simulate the compute timeline, then walk ops in
ascending *end time* and enqueue the send ``Start`` on the producer stage AND
the matching receive ``Start`` on the consumer stage *at the same moment*.
Because every (send, recv) pair is appended to both endpoints' comm queues
together, the per-device-pair communication order is identical on both sides
by construction — the property whose violation deadlocks NCCL-like in-order
channels. ``Wait`` ops are placed as late as possible: immediately before the
compute op that consumes the received tensor.

``check_order_consistency`` verifies the property (used by tests, and by the
naive-plan counterexample that reproduces the paper's deadlock).
"""
from __future__ import annotations

from collections import defaultdict

from repro_torch.core.instructions import Instr, MicroBatchSpec, Op
from repro_torch.core.simulator import SimResult, simulate


def _tensor_shape(mb: MicroBatchSpec, d_model: int) -> tuple:
    seq = mb.seq if not isinstance(mb.seq, (tuple, list)) else mb.seq[0] + mb.seq[1]
    return (mb.mbs, int(seq), d_model)


def build_instructions(
    order: list[list[tuple[int, str]]],
    micro_batches: list[MicroBatchSpec],
    sim: SimResult,
    d_model: int = 0,
    naive: bool = False,
) -> list[list[Instr]]:
    """Merge compute + comm ops into per-stage instruction streams.

    ``naive=True`` reproduces the deadlock-prone baseline: sends are issued
    at production time, receives *just before use* — the per-pair orders can
    then disagree (paper Fig. 8b).
    """
    n_stages = len(order)
    mb = {m.mb_id: m for m in micro_batches}

    # comm events sorted by producer end time
    events = []  # (t, seq, producer, consumer, op_send, op_recv, mb_id)
    for (i, j, kind), t_end in sorted(sim.end.items(), key=lambda kv: (kv[1], kv[0])):
        if kind == "F" and j + 1 < n_stages:
            events.append((t_end, i, j, j + 1, Op.SEND_ACT_START, Op.RECV_ACT_START))
        elif kind == "B" and j > 0:
            events.append((t_end, i, j, j - 1, Op.SEND_GRAD_START, Op.RECV_GRAD_START))

    # per-stage: interleave comm Starts between compute ops by time
    streams: list[list[Instr]] = [[] for _ in range(n_stages)]
    compute_seq = {
        j: sorted(
            ((sim.end[(i, j2, k)], i, k) for (i, j2, k) in sim.end if j2 == j),
            key=lambda x: x[0],
        )
        for j in range(n_stages)
    }

    # Build merged event list per stage: compute completions + comm enqueues.
    # Ties at identical timestamps MUST break on a *global* sequence number:
    # both endpoints of a (send, recv) pair carry the same seq, so their
    # relative order is identical on both devices. (A local send-before-recv
    # priority would order the two endpoints differently and deadlock —
    # caught by test_planned_comm_always_consistent.)
    per_stage_events: list[list[tuple]] = [[] for _ in range(n_stages)]
    for j in range(n_stages):
        for t_end, i, kind in compute_seq[j]:
            per_stage_events[j].append((t_end, -1, "compute", i, kind))
    for seq, (t, i, src, dst, op_s, op_r) in enumerate(events):
        shape = _tensor_shape(mb[i], d_model)
        per_stage_events[src].append((t, seq, "comm", Instr(op_s, i, dst, shape)))
        if not naive:
            per_stage_events[dst].append((t, seq, "comm", Instr(op_r, i, src, shape)))

    for j in range(n_stages):
        per_stage_events[j].sort(key=lambda e: (e[0], e[1]))
        for ev in per_stage_events[j]:
            if ev[2] == "compute":
                _, _, _, i, kind = ev
                if kind == "F":
                    if j > 0:
                        if naive:
                            shape = _tensor_shape(mb[i], d_model)
                            streams[j].append(Instr(Op.RECV_ACT_START, i, j - 1, shape))
                        streams[j].append(Instr(Op.WAIT_RECV_ACT, i, j - 1))
                    streams[j].append(Instr(Op.FORWARD, i))
                else:
                    if j + 1 < n_stages:
                        if naive:
                            shape = _tensor_shape(mb[i], d_model)
                            streams[j].append(Instr(Op.RECV_GRAD_START, i, j + 1, shape))
                        streams[j].append(Instr(Op.WAIT_RECV_GRAD, i, j + 1))
                    streams[j].append(Instr(Op.BACKWARD, i))
            else:
                streams[j].append(ev[3])
        streams[j].append(Instr(Op.REDUCE_AND_STEP))
    return streams


def comm_order_per_pair(streams: list[list[Instr]]):
    """For each (device, peer): ordered list of comm ops (Starts only)."""
    pair_order: dict[tuple[int, int], list[tuple[str, int]]] = defaultdict(list)
    for j, stream in enumerate(streams):
        for ins in stream:
            if ins.op in (Op.SEND_ACT_START, Op.SEND_GRAD_START):
                pair_order[(j, ins.peer)].append(("S", ins.micro_batch, ins.op.value))
            elif ins.op in (Op.RECV_ACT_START, Op.RECV_GRAD_START):
                pair_order[(j, ins.peer)].append(("R", ins.micro_batch, ins.op.value))
    return pair_order


def check_order_consistency(streams: list[list[Instr]]) -> list[str]:
    """Returns mismatch descriptions ([] == provably deadlock-free for
    in-order single-channel links)."""
    pair_order = comm_order_per_pair(streams)
    problems = []
    seen = set()
    for (a, b) in list(pair_order):
        if (b, a) in seen:
            continue
        seen.add((a, b))
        mine = pair_order[(a, b)]
        theirs = pair_order.get((b, a), [])
        if len(mine) != len(theirs):
            problems.append(f"pair ({a},{b}): count {len(mine)} vs {len(theirs)}")
            continue
        for x, y in zip(mine, theirs):
            # my send must match their recv of same mb (and vice versa)
            if x[0] == y[0] or x[1] != y[1]:
                problems.append(f"pair ({a},{b}): {x} vs {y}")
                break
    return problems
