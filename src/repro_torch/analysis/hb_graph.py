"""Happens-before graph over an ExecutionPlan's instruction streams.

The model mirrors ``core/executor.py`` exactly. Each stage runs two
threads: a *compute* thread that walks its stream in order — FORWARD,
BACKWARD, WAIT_* and REDUCE_AND_STEP block it, while SEND/RECV Start ops
are enqueued (non-blocking) to the stage's *comm* thread — and the comm
thread, which executes the Start ops serially against rendezvous,
in-order channels (one per directed stage pair). A SEND first blocks
until the compute thread has produced its payload, then blocks until the
conjugate RECV consumes it; a RECV blocks until the head message of its
channel is available (and the head's tag must match, or the executor
raises DeadlockError).

Nodes (per instruction at stream position ``idx`` of ``stage``):

- compute op  -> one event   ``(stage, idx, "done")``
- comm Start  -> two events  ``(stage, idx, "issue")`` (comm thread
  dequeues it) and ``(stage, idx, "done")`` (the op completes)

Edges (u must happen before v):

1. program order      prev blocking compute done -> next blocking done
2. enqueue            last blocking compute before a Start -> Start issue
3. comm serialization prev comm done on the stage -> next comm issue
4. start-before-done  Start issue -> Start done
5. rendezvous         send issue -> recv done (message posted);
                      recv done -> send done (consumption releases sender)
6. payload            producing F/B done -> recv done (a send cannot post
                      before the compute thread produced the tensor)
7. channel FIFO       for consecutive sends on one directed channel, the
                      earlier message's recv done -> the later's recv done
8. wait               matching recv done -> WAIT done

A plan deadlocks iff this graph has a directed cycle: every blocked
executor thread waits on exactly the predecessors above, so a cycle is a
circular wait, and acyclicity gives a global topological order in which
every op completes (the simulator's timeline is one such order for §6
plans). ``find_cycle`` returns a *minimal* counterexample: the shortest
cycle inside the smallest cyclic strongly-connected component.
"""
from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.instructions import (
    RECV_OPS,
    SEND_OPS,
    WAIT_OPS,
    ExecutionPlan,
    Instr,
    Op,
)

# (stage, index-in-stream, "issue" | "done")
Node = tuple[int, int, str]

_KIND = {
    Op.SEND_ACT_START: "act", Op.RECV_ACT_START: "act",
    Op.WAIT_RECV_ACT: "act",
    Op.SEND_GRAD_START: "grad", Op.RECV_GRAD_START: "grad",
    Op.WAIT_RECV_GRAD: "grad",
}


@dataclass
class HBGraph:
    plan: ExecutionPlan
    # forward adjacency, each edge labelled with the rule that added it
    edges: dict[Node, list[tuple[Node, str]]] = field(default_factory=dict)
    # comm Starts that never pair up (deadlocks at runtime; lint names them)
    unpaired: list[tuple[int, int]] = field(default_factory=list)

    def add_edge(self, u: Node, v: Node, why: str) -> None:
        self.edges.setdefault(u, []).append((v, why))
        self.edges.setdefault(v, [])

    def n_edges(self) -> int:
        return sum(len(vs) for vs in self.edges.values())

    def instr(self, node: Node) -> Instr:
        return self.plan.per_stage[node[0]][node[1]]

    def describe_node(self, node: Node) -> str:
        stage, idx, ev = node
        return f"stage {stage} #{idx} {self.instr(node).short()} ({ev})"

    def edge_reason(self, u: Node, v: Node) -> str:
        for w, why in self.edges.get(u, []):
            if w == v:
                return why
        return "?"

    # ---------------- cycle detection ----------------
    def find_cycle(self) -> Optional[list[Node]]:
        """Shortest cycle of the smallest cyclic SCC, or None if the graph
        is acyclic (i.e. the plan is statically deadlock-free)."""
        sccs = self._cyclic_sccs()
        if not sccs:
            return None
        scc = min(sccs, key=len)
        members = set(scc)
        best: Optional[list[Node]] = None
        for start in scc:
            cyc = self._bfs_cycle(start, members)
            if cyc is not None and (best is None or len(cyc) < len(best)):
                best = cyc
        return best

    def describe_cycle(self, cycle: list[Node]) -> list[str]:
        """Human-readable circular-wait chain, one line per edge."""
        lines = []
        for k, u in enumerate(cycle):
            v = cycle[(k + 1) % len(cycle)]
            lines.append(f"{self.describe_node(u)} -> "
                         f"{self.describe_node(v)}  [{self.edge_reason(u, v)}]")
        return lines

    def _cyclic_sccs(self) -> list[list[Node]]:
        """Tarjan (iterative): SCCs with more than one node, plus single
        nodes carrying a self-loop."""
        index: dict[Node, int] = {}
        low: dict[Node, int] = {}
        on_stack: set[Node] = set()
        stack: list[Node] = []
        out: list[list[Node]] = []
        counter = [0]

        for root in self.edges:
            if root in index:
                continue
            # work items: (node, iterator position)
            work = [(root, 0)]
            while work:
                node, pi = work.pop()
                if pi == 0:
                    index[node] = low[node] = counter[0]
                    counter[0] += 1
                    stack.append(node)
                    on_stack.add(node)
                succs = [v for v, _ in self.edges.get(node, [])]
                advanced = False
                for i in range(pi, len(succs)):
                    w = succs[i]
                    if w not in index:
                        work.append((node, i + 1))
                        work.append((w, 0))
                        advanced = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    if len(scc) > 1 or any(
                            v == node for v, _ in self.edges.get(node, [])):
                        out.append(scc)
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
        return out

    def _bfs_cycle(self, start: Node,
                   members: set[Node]) -> Optional[list[Node]]:
        """Shortest path start -> start staying inside ``members``."""
        prev: dict[Node, Node] = {}
        q = deque([start])
        seen = {start}
        while q:
            u = q.popleft()
            for v, _ in self.edges.get(u, []):
                if v == start:
                    path = [u]
                    while u != start:
                        u = prev[u]
                        path.append(u)
                    path.reverse()
                    return path
                if v in members and v not in seen:
                    seen.add(v)
                    prev[v] = u
                    q.append(v)
        return None


def build_hb_graph(plan: ExecutionPlan) -> HBGraph:
    g = HBGraph(plan)
    # producer of each payload: ("act"|"grad", mb) per stage -> done node
    producer: dict[tuple[int, str, int], Node] = {}
    # per directed channel (src, dst): sends/recvs in comm-stream order
    sends: dict[tuple[int, int], list[tuple[Node, Node, tuple]]] = \
        defaultdict(list)   # (issue, done, tag)
    recvs: dict[tuple[int, int], list[tuple[Node, Node, tuple]]] = \
        defaultdict(list)
    waits: list[tuple[Node, int, tuple]] = []   # (done-node, stage, tag)

    for j, stream in enumerate(plan.per_stage):
        last_blocking: Optional[Node] = None
        last_comm: Optional[Node] = None
        for idx, ins in enumerate(stream):
            if ins.op in SEND_OPS or ins.op in RECV_OPS:
                issue: Node = (j, idx, "issue")
                done: Node = (j, idx, "done")
                g.edges.setdefault(issue, [])
                if last_blocking is not None:
                    g.add_edge(last_blocking, issue,
                               "compute thread enqueues comm ops in "
                               "stream order")
                if last_comm is not None:
                    g.add_edge(last_comm, issue,
                               "comm thread is serial per stage")
                g.add_edge(issue, done, "a Start completes after it is "
                                        "issued")
                last_comm = done
                tag = (_KIND[ins.op], ins.micro_batch)
                if ins.op in SEND_OPS:
                    sends[(j, ins.peer)].append((issue, done, tag))
                else:
                    recvs[(ins.peer, j)].append((issue, done, tag))
            else:
                node: Node = (j, idx, "done")
                g.edges.setdefault(node, [])
                if last_blocking is not None:
                    g.add_edge(last_blocking, node, "program order on the "
                                                    "compute thread")
                last_blocking = node
                if ins.op is Op.FORWARD:
                    producer[(j, "act", ins.micro_batch)] = node
                elif ins.op is Op.BACKWARD:
                    producer[(j, "grad", ins.micro_batch)] = node
                elif ins.op in WAIT_OPS:
                    waits.append((node, j, (_KIND[ins.op],
                                            ins.micro_batch)))

    # pair sends and recvs per channel: the k-th send of a tag matches the
    # k-th recv of the same tag on the same directed channel
    matched_recv: dict[tuple[int, tuple], Node] = {}   # (dst, tag) -> done
    for ch in set(sends) | set(recvs):
        by_tag: dict[tuple, deque] = defaultdict(deque)
        for r_issue, r_done, tag in recvs[ch]:
            by_tag[tag].append((r_issue, r_done))
        rds: list[Optional[Node]] = []
        for s_issue, s_done, tag in sends[ch]:
            if by_tag[tag]:
                r_issue, r_done = by_tag[tag].popleft()
                g.add_edge(s_issue, r_done,
                           "message posted by the sender's comm thread")
                g.add_edge(r_done, s_done,
                           "rendezvous: the send completes when the "
                           "receiver consumes it")
                src, dst = ch
                prod = producer.get((src, tag[0], tag[1]))
                if prod is not None:
                    g.add_edge(prod, r_done,
                               "payload produced before the send can post")
                matched_recv.setdefault((dst, tag), r_done)
                rds.append(r_done)
            else:
                g.unpaired.append((s_issue[0], s_issue[1]))
                rds.append(None)
        for rest in by_tag.values():
            for r_issue, _r_done in rest:
                g.unpaired.append((r_issue[0], r_issue[1]))
        # channel FIFO: the i-th posted message must be consumed before
        # the (i+1)-th can be (in-order channel, head-of-line blocking)
        prev_rd: Optional[Node] = None
        for rd in rds:
            if rd is None:
                continue
            if prev_rd is not None and prev_rd != rd:
                g.add_edge(prev_rd, rd, "in-order channel: head-of-line "
                                        "blocking")
            prev_rd = rd

    # WAIT fences: the compute thread blocks until the stage's comm thread
    # completed the matching recv
    for w_done, stage, tag in waits:
        rd = matched_recv.get((stage, tag))
        if rd is None:
            # fall back to any recv with this tag on this stage, matched
            # or not; a wait with no recv at all is a lint error (and an
            # executor timeout), not an HB edge
            for ch, entries in recvs.items():
                if ch[1] != stage:
                    continue
                for _ri, r_done, t in entries:
                    if t == tag:
                        rd = r_done
                        break
                if rd is not None:
                    break
        if rd is not None:
            g.add_edge(rd, w_done, "WAIT fences the compute thread on the "
                                   "completed recv")
    return g
