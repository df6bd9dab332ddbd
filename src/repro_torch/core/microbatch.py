"""Micro-batch construction (paper §4).

Pipeline: ``order_samples`` -> ``dp_split`` (the O(N^4)-worst-case dynamic
program of Eq. 2 with the t_max sweep, banded + bucketed for speed) ->
``balance_replicas`` (Karmarkar–Karp across data-parallel pipelines,
extended with per-replica speed factors for straggler mitigation).

The objective is the paper's Eq. 1 pipeline-makespan model:

    t_iter = (c - 1) · max_i t(M_i) + (1/|D|) · Σ_i t(M_i)

(|D| = number of data-parallel replicas; 1 for pure pipeline parallelism).
Costs come from a :class:`~repro_torch.core.cost_model.CostModel` and are charged
at *bucketed* shapes when a :class:`~repro_torch.core.shapes.ShapePalette` is given
(TPU adaptation — the DP then optimizes the padded cost it will actually pay).

``dp_split`` is the vectorized fast path (planning must stay well under
iteration time to run ahead of the pipeline, §3/§8.5): the banded group
table is built by bucketing shapes first and evaluating only the distinct
``(mbs, enc, dec)`` triples through ``CostModel.stage_times_batch`` into a
process-wide memoized LUT, and the t_max sweep solves the band recurrence
for whole blocks of candidates at once, pruning dominated candidates with
the Eq. 1 lower bound ``(c-1)·t_max + Σt_min/|D|``. ``dp_split_reference``
is the original scalar implementation — both return identical Eq. 1
objectives and identical cuts under the shared deterministic tie-breaking
(smallest t_max, then smallest group-start index wins ties).
"""
from __future__ import annotations

import heapq
import weakref
from dataclasses import dataclass

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from repro_torch.core.cost_model import (CostModel, encode_shape_triples,
                                   unique_shape_triples)
from repro_torch.core.shapes import ShapePalette


@dataclass
class MicroBatch:
    indices: list[int]            # positions into the *ordered* sample list
    n_samples: int
    mbs: int                      # padded row count (bucketed)
    seq: object                   # padded seq len (int or (enc, dec))
    t_fwd: float
    t_bwd: float
    mem: float

    @property
    def t(self) -> float:
        return self.t_fwd + self.t_bwd

    @property
    def padded_tokens(self) -> int:
        if isinstance(self.seq, tuple):
            return self.mbs * (self.seq[0] + self.seq[1])
        return self.mbs * self.seq


def _as2d(lengths) -> np.ndarray:
    a = np.asarray(lengths, dtype=np.int64)
    if a.ndim == 1:
        a = np.stack([a, np.zeros_like(a)], axis=1)
    return a


# ----------------------------------------------------------------------
# sample ordering (paper §4 "Determine the order of samples")
# ----------------------------------------------------------------------
def order_samples(lengths, method: str = "sort") -> np.ndarray:
    """Returns a permutation of sample indices.

    "sort": lexicographic by (enc_len, dec_len) — the paper's default.
    "tsp" : greedy nearest-neighbour tour over (enc, dec) points — the
            paper's TSP-solver alternative (§8.4 shows they perform alike).
    """
    pts = _as2d(lengths)
    n = len(pts)
    if method == "sort":
        return np.lexsort((pts[:, 1], pts[:, 0]))
    if method == "tsp":
        # greedy nearest-neighbour over a boolean liveness mask: each step is
        # one masked argmin over flat arrays instead of rebuilding a Python
        # set + np.fromiter per hop (which made the tour quadratic in Python
        # overhead at n >= 4k)
        p = pts.astype(np.float64)
        x, y = p[:, 0], p[:, 1]
        alive = np.ones(n, dtype=bool)
        order = np.empty(n, dtype=np.int64)
        cur = int(np.argmin(pts.sum(1)))
        order[0] = cur
        alive[cur] = False
        d = np.empty(n)
        for step in range(1, n):
            np.abs(x - x[cur], out=d)
            d += np.abs(y - y[cur])
            d[~alive] = np.inf
            cur = int(np.argmin(d))
            order[step] = cur
            alive[cur] = False
        return order
    raise ValueError(method)


# ----------------------------------------------------------------------
# group cost tables
# ----------------------------------------------------------------------
def _group_cost(cost: CostModel, count: int, enc: int, dec: int,
                palette: ShapePalette | None, tp: int):
    if palette is not None:
        count = palette.bucket_mbs(count)
        enc = palette.bucket_seq(enc) if enc else 0
        dec = palette.bucket_seq(dec) if dec else 0
    seq = (enc, dec) if dec else enc
    tf = cost.stage_fwd_time(count, seq, tp)
    tb = cost.stage_bwd_time(count, seq, tp)
    mem = cost.stage_act_memory(count, seq, tp)
    return count, seq, tf, tb, mem


class GroupCostLUT:
    """Memoized (mbs, enc, dec) -> (t_fwd, t_bwd, mem) group-cost table.

    Misses are evaluated through ``CostModel.stage_times_batch`` in one
    vectorized call; hits are a sorted-key ``searchsorted`` gather. The LUT
    key is the *bucketed* shape, so with a :class:`ShapePalette` the table
    saturates at |mbs_buckets| x |seq_buckets|^2 entries and later planning
    iterations are pure gathers. Without a palette the raw-shape key space
    is unbounded across iterations, so the store is dropped and rebuilt
    whenever it would exceed ``max_entries`` — planning stays fast within a
    phase of similar length distributions while memory stays bounded.
    Instances are shared per cost model via :func:`group_cost_lut`;
    ``hits``/``misses`` expose cache behaviour.
    """

    def __init__(self, cost: CostModel, tp: int = 1,
                 max_entries: int = 2_000_000):
        # hold the model weakly: LUTs live as values of the _GROUP_LUTS
        # WeakKeyDictionary keyed by the model, and a strong value->key
        # reference would make every entry (and its up-to-max_entries store)
        # immortal
        try:
            self._cost_ref = weakref.ref(cost)
        except TypeError:                 # non-weakrefable model: strong ref
            self._cost_ref = (lambda c=cost: c)
        self.tp = tp
        self.max_entries = max_entries
        self._store = (np.empty(0, dtype=np.int64), np.empty((0, 3)))
        self.hits = 0
        self.misses = 0

    @property
    def cost(self) -> CostModel:
        c = self._cost_ref()
        if c is None:
            raise ReferenceError("cost model for this GroupCostLUT was "
                                 "garbage-collected")
        return c

    def __len__(self) -> int:
        return len(self._store[0])

    def lookup(self, cnt, enc, dec):
        """cnt/enc/dec: unique int64 shape arrays -> (tf, tb, mem) arrays."""
        keys = encode_shape_triples(cnt, enc, dec)
        if keys is None:                      # un-packable range: no caching
            self.misses += len(cnt)
            return self.cost.stage_times_batch(
                cnt, np.stack([enc, dec], axis=1), self.tp)
        kk, vv = self._store                  # atomic snapshot (thread use)
        pos = np.searchsorted(kk, keys)
        found = np.zeros(len(keys), dtype=bool)
        inb = pos < len(kk)
        found[inb] = kk[pos[inb]] == keys[inb]
        n_hit = int(found.sum())
        self.hits += n_hit
        self.misses += len(keys) - n_hit
        out = np.empty((len(keys), 3))
        out[found] = vv[pos[found]]
        miss = ~found
        if miss.any():
            tf, tb, mem = self.cost.stage_times_batch(
                cnt[miss], np.stack([enc[miss], dec[miss]], axis=1), self.tp)
            out[miss, 0], out[miss, 1], out[miss, 2] = tf, tb, mem
            if len(kk) + int(miss.sum()) > self.max_entries:
                kk, vv = keys[:0], out[:0]     # reset: keep only the new batch
            nk = np.concatenate([kk, keys[miss]])
            nv = np.concatenate([vv, out[miss]])
            order = np.argsort(nk, kind="stable")
            self._store = (nk[order], nv[order])
        return out[:, 0], out[:, 1], out[:, 2]


_GROUP_LUTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def group_cost_lut(cost: CostModel, tp: int = 1) -> GroupCostLUT:
    """The process-wide LUT for ``cost`` (fresh, uncached instance if the
    model cannot be weak-referenced)."""
    try:
        per_model = _GROUP_LUTS.setdefault(cost, {})
    except TypeError:
        return GroupCostLUT(cost, tp)
    lut = per_model.get(tp)
    if lut is None:
        lut = per_model[tp] = GroupCostLUT(cost, tp)
    return lut


def _build_group_tables(L, cost, band, mem_limit, palette):
    """Vectorized banded group table over groups [i, i+w), w <= band.

    Returns ``(t_tab, ok, cell_tab, shapes)``: ``t_tab``/``ok``/``cell_tab``
    are (n, band) arrays indexed [i, w-1] (total group time, liveness, index
    into the distinct-shape axis) and ``shapes`` is the distinct-shape tuple
    ``(cnt, enc, dec, t_fwd, t_bwd, mem)``. ``ok`` matches the reference's
    early-break semantics: w = 1 is always tabulated; the first over-limit or
    palette-overflowing w > 1 kills all larger widths of that start.
    """
    n = len(L)
    pad = np.zeros(band - 1, dtype=np.int64)
    # banded running max over (enc, dec): the inner Python loop becomes one
    # sliding-window cummax per side
    enc_max = np.maximum.accumulate(
        sliding_window_view(np.concatenate([L[:, 0], pad]), band), axis=1)
    dec_max = np.maximum.accumulate(
        sliding_window_view(np.concatenate([L[:, 1], pad]), band), axis=1)
    w_row = np.arange(1, band + 1, dtype=np.int64)
    valid = w_row[None, :] <= (n - np.arange(n))[:, None]
    vi = np.nonzero(valid.ravel())[0]
    cnt_r = np.broadcast_to(w_row, (n, band)).ravel()[vi]
    enc_r = enc_max.ravel()[vi]
    dec_r = dec_max.ravel()[vi]

    # bucket first, then cost only the distinct shapes
    cu, eu, du, inv = unique_shape_triples(cnt_r, enc_r, dec_r)
    overflow_u = np.zeros(len(cu), dtype=bool)
    if palette is not None:
        cu, ov_m = palette.bucket_mbs_array(cu)
        eb, ov_e = palette.bucket_seq_array(eu)
        db, ov_d = palette.bucket_seq_array(du)
        overflow_u = ov_m | (ov_e & (eu > 0)) | (ov_d & (du > 0))
        eu = np.where(eu > 0, eb, 0)
        du = np.where(du > 0, db, 0)
        cu2, eu2, du2, inv2 = unique_shape_triples(cu, eu, du)
        cell = inv2[inv]
    else:
        cu2, eu2, du2 = cu, eu, du
        cell = inv

    ov_cells = overflow_u[inv]
    bad_single = ov_cells & (cnt_r == 1)
    if bool(bad_single.any()):
        # the offender is whichever side exceeds the top bucket (dec can
        # overflow while enc fits)
        bad = int(max(enc_r[bad_single].max(), dec_r[bad_single].max()))
        raise ValueError(f"seq_len {bad} exceeds palette max "
                         f"{palette.seq_buckets[-1]}")

    lut = group_cost_lut(cost)
    tf_u, tb_u, mem_u = lut.lookup(cu2, eu2, du2)

    cell_tab = np.full(n * band, -1, dtype=np.int64)
    cell_tab[vi] = cell
    cell_tab = cell_tab.reshape(n, band)

    over = np.zeros(n * band, dtype=bool)
    over[vi] = (mem_u[cell] > mem_limit) | ov_cells
    over = over.reshape(n, band)
    over[:, 0] = False                 # w == 1 always enters the table
    dead = np.logical_or.accumulate(over, axis=1)
    ok = valid & ~dead

    t_tab = np.full(n * band, np.inf)
    t_tab[vi] = tf_u[cell] + tb_u[cell]
    t_tab = t_tab.reshape(n, band)
    t_tab[~ok] = np.inf
    return t_tab, ok, cell_tab, (cu2, eu2, du2, tf_u, tb_u, mem_u)


def _sweep_block(t_cands, G, n, band):
    """Band DP for a whole block of t_max candidates at once.

    f[r, j] = min total time over partitions of samples [0, j) with every
    group time <= t_cands[r]. Returns (f[:, n], backpointers). Backpointer
    entries for infeasible (f = inf) states are never followed — any finite
    f[n] chains through finite predecessors only.
    """
    K = len(t_cands)
    F = np.full((K, n + 1), np.inf)
    F[:, 0] = 0.0
    B = np.full((K, n + 1), -1, dtype=np.int64)
    thr = t_cands[:, None] + 1e-12
    rows = np.arange(K)
    tot = np.empty((K, band))
    msk = np.empty((K, band), dtype=bool)
    for j in range(1, n + 1):
        lo = j - band if j > band else 0
        w = j - lo
        g = G[j - 1, :w]               # group times ending at j, start ascending
        t = tot[:, :w]
        np.add(F[:, lo:j], g, out=t)
        m = msk[:, :w]
        np.greater(g, thr, out=m)
        t[m] = np.inf
        k = t.argmin(axis=1)
        F[:, j] = t[rows, k]
        B[:, j] = k
        B[:, j] += lo
    return F[:, n], B


def dp_split(
    ordered_lengths,
    cost: CostModel,
    n_stages: int,
    *,
    mem_limit: float = float("inf"),
    dp_size: int = 1,
    palette: ShapePalette | None = None,
    t_max_interval: float = 5e-6,     # paper: sample t_max 5us apart
    max_group: int = 512,
    mem_limit_factor: float | None = None,
) -> list[MicroBatch]:
    """Optimal contiguous partition of the ordered samples (paper Eq. 2).

    ``mem_limit`` is the per-micro-batch activation budget; with 1F1B it is
    device_mem/n_stages, adaptive schedules pass their own factor (§4 "Limit
    memory consumption" / §5).

    This is the vectorized fast path; see the module docstring. It returns
    the same Eq. 1 objective and the same cuts as :func:`dp_split_reference`.
    """
    L = _as2d(ordered_lengths)
    n = len(L)
    if n == 0:
        return []
    c = n_stages
    if mem_limit_factor is not None:
        mem_limit = mem_limit * mem_limit_factor
    if palette is not None:
        max_group = min(max_group, palette.mbs_buckets[-1])
    band = min(max_group, n)

    t_tab, ok, cell_tab, shapes = _build_group_tables(
        L, cost, band, mem_limit, palette)
    cnt_u, enc_u, dec_u, tf_u, tb_u, mem_u = shapes

    feasible = t_tab[ok]
    if feasible.size == 0:
        raise ValueError("no feasible micro-batch under the memory limit; "
                         "even a single sample exceeds it")

    # candidate t_max values: unique group times, subsampled at the interval
    # (paper: 5us apart); same construction as the reference.
    interval = min(t_max_interval, max(float(feasible.min()) / 4, 1e-12))
    cand = np.unique(np.round(feasible / interval) * interval)
    cand = np.clip(cand, feasible.min(), None)
    cand = np.unique(np.append(cand, [feasible.min(), feasible.max()]))

    # Diagonal layout: G[j-1, k] = t(group [i, j)) with i = lo + k ascending,
    # so each DP step is one contiguous gather.
    J = np.arange(1, n + 1)
    lo_j = np.maximum(0, J - band)
    I = lo_j[:, None] + np.arange(band)[None, :]
    W = J[:, None] - I
    m = I < J[:, None]
    G = np.full((n, band), np.inf)
    G[m] = t_tab[I[m], W[m] - 1]

    # Collapse candidates to mask classes: two candidates admitting the same
    # set of group times yield identical DP tables, and within a class the
    # smallest t_max dominates under Eq. 1 — so only class representatives
    # (= first candidate of each class, candidates ascending) need solving.
    vals = np.unique(feasible)
    cls = np.searchsorted(vals, cand + 1e-12, side="right") - 1
    first = np.ones(len(cand), dtype=bool)
    first[1:] = cls[1:] != cls[:-1]
    reps = cand[first]

    # The largest representative admits every group: its total is the global
    # minimum Σt, which powers the Eq. 1 lower bound used for pruning.
    hiF, hiB = _sweep_block(reps[-1:], G, n, band)
    total_min = float(hiF[0])
    obj_hi = (c - 1) * reps[-1] + hiF[0] / dp_size

    # prune: lower bound (c-1)*t + Σt_min/|D| already beaten, or t below the
    # feasibility floor (some sample has no admissible group at all)
    rest = reps[:-1]
    t_floor = float(G.min(axis=1).max())
    ub = float(obj_hi)
    lb_rest = (c - 1) * rest + total_min / dp_size
    pending = rest[(lb_rest <= ub) & (rest + 1e-12 >= t_floor)]

    results = []                       # (t_max, obj, back) ascending in t_max
    while pending.size:
        blk = pending[:64]
        pending = pending[64:]
        FN, B = _sweep_block(blk, G, n, band)
        objs = (c - 1) * blk + FN / dp_size
        bi = int(np.argmin(objs))
        if np.isfinite(objs[bi]):
            results.append((float(blk[bi]), float(objs[bi]), B[bi]))
            ub = min(ub, float(objs[bi]))
        if pending.size:
            lb = (c - 1) * pending + total_min / dp_size
            pending = pending[lb <= ub]
    results.append((float(reps[-1]), float(obj_hi), hiB[0]))

    best = None
    for t_max, obj, back in results:   # ascending; strict < keeps smallest t
        if np.isfinite(obj) and (best is None or obj < best[0]):
            best = (obj, t_max, back)
    if best is None:
        raise ValueError("DP infeasible at every t_max")
    _, t_max, back = best

    # reconstruct
    cuts = []
    j = n
    while j > 0:
        i = int(back[j])
        cuts.append((i, j))
        j = i
    cuts.reverse()
    out = []
    for i, j in cuts:
        u = int(cell_tab[i, j - i - 1])
        e, d = int(enc_u[u]), int(dec_u[u])
        seq = (e, d) if d else e
        out.append(MicroBatch(list(range(i, j)), j - i, int(cnt_u[u]), seq,
                              float(tf_u[u]), float(tb_u[u]), float(mem_u[u])))
    return out


def dp_split_reference(
    ordered_lengths,
    cost: CostModel,
    n_stages: int,
    *,
    mem_limit: float = float("inf"),
    dp_size: int = 1,
    palette: ShapePalette | None = None,
    t_max_interval: float = 5e-6,
    max_group: int = 512,
    mem_limit_factor: float | None = None,
) -> list[MicroBatch]:
    """The original scalar Eq. 2 solver, kept as the correctness oracle.

    Evaluates the cost model one group at a time and re-runs the band DP per
    t_max candidate — O(n·band) cost-model calls plus O(|cand|·n·band) DP
    work. Use it to validate :func:`dp_split` (property tests assert equal
    objectives and cuts) or when debugging a new :class:`CostModel`, whose
    scalar methods are all this path touches.
    """
    L = _as2d(ordered_lengths)
    n = len(L)
    if n == 0:
        return []
    c = n_stages
    if mem_limit_factor is not None:
        mem_limit = mem_limit * mem_limit_factor

    # banded tables over groups [i, j): j - i <= max_group
    if palette is not None:
        max_group = min(max_group, palette.mbs_buckets[-1])
    band = min(max_group, n)
    t_tab = np.full((n, band + 1), np.inf)     # t_tab[i, w] = t(group i..i+w)
    m_tab = np.full((n, band + 1), np.inf)
    enc_max = np.zeros((n, band + 1), dtype=np.int64)
    dec_max = np.zeros((n, band + 1), dtype=np.int64)
    meta: dict[tuple[int, int], tuple] = {}
    for i in range(n):
        emax = dmax = 0
        for w in range(1, min(band, n - i) + 1):
            emax = max(emax, int(L[i + w - 1, 0]))
            dmax = max(dmax, int(L[i + w - 1, 1]))
            enc_max[i, w], dec_max[i, w] = emax, dmax
            try:
                cnt, seq, tf, tb, mem = _group_cost(cost, w, emax, dmax,
                                                    palette, 1)
            except ValueError:
                if w == 1:
                    raise              # a single sample must fit the palette
                break                  # longer groups only overflow harder
            if mem > mem_limit and w > 1:
                break  # larger groups only grow memory
            t_tab[i, w] = tf + tb
            m_tab[i, w] = mem
            meta[(i, w)] = (cnt, seq, tf, tb, mem)

    feasible = t_tab[np.isfinite(t_tab)]
    if feasible.size == 0:
        raise ValueError("no feasible micro-batch under the memory limit; "
                         "even a single sample exceeds it")

    # candidate t_max values: unique group times, subsampled at the interval
    # (paper: 5us apart). If the interval is coarse relative to the actual
    # times (tiny models), fall back to a relative grid so the sweep never
    # collapses to an empty candidate set.
    interval = min(t_max_interval, max(float(feasible.min()) / 4, 1e-12))
    cand = np.unique(np.round(feasible / interval) * interval)
    cand = np.clip(cand, feasible.min(), None)
    cand = np.unique(np.append(cand, [feasible.min(), feasible.max()]))

    best = None
    for t_max in cand:
        # f[j] = min total time to partition first j samples with all groups <= t_max
        f = np.full(n + 1, np.inf)
        back = np.full(n + 1, -1, dtype=np.int64)
        f[0] = 0.0
        for j in range(1, n + 1):
            lo = max(0, j - band)
            widths = j - np.arange(lo, j)          # group widths for start i
            ti = t_tab[np.arange(lo, j), widths]
            tot = f[lo:j] + ti
            tot[ti > t_max + 1e-12] = np.inf
            k = int(np.argmin(tot))
            if np.isfinite(tot[k]):
                f[j] = tot[k]
                back[j] = lo + k
        if not np.isfinite(f[n]):
            continue
        obj = (c - 1) * t_max + f[n] / dp_size
        if best is None or obj < best[0]:
            best = (obj, t_max, f[n], back.copy())

    if best is None:
        raise ValueError("DP infeasible at every t_max")
    _, t_max, _, back = best

    # reconstruct
    cuts = []
    j = n
    while j > 0:
        i = int(back[j])
        cuts.append((i, j))
        j = i
    cuts.reverse()
    out = []
    for i, j in cuts:
        cnt, seq, tf, tb, mem = meta[(i, j - i)]
        out.append(MicroBatch(list(range(i, j)), j - i, cnt, seq, tf, tb, mem))
    return out


def iteration_time(micro_batches: list[MicroBatch], n_stages: int,
                   dp_size: int = 1) -> float:
    """The paper's Eq. 1 estimate for a given split."""
    if not micro_batches:
        return 0.0
    tmax = max(m.t for m in micro_batches)
    return (n_stages - 1) * tmax + sum(m.t for m in micro_batches) / dp_size


# ----------------------------------------------------------------------
# replica balancing (paper §4 "Balance data parallel model replicas")
# ----------------------------------------------------------------------
def karmarkar_karp(values: list[float], k: int) -> list[list[int]]:
    """Multiway Karmarkar–Karp differencing. Returns k index lists."""
    if k <= 1:
        return [list(range(len(values)))]
    heap = []
    for idx, v in enumerate(values):
        sums = [0.0] * k
        sets: list[list[int]] = [[] for _ in range(k)]
        sums[0] = v
        sets[0] = [idx]
        heap.append((-v, idx, sums, sets))
    heapq.heapify(heap)
    tiebreak = len(values)
    while len(heap) > 1:
        d1, _, s1, p1 = heapq.heappop(heap)
        d2, _, s2, p2 = heapq.heappop(heap)
        # combine: largest of one with smallest of the other
        order1 = np.argsort(s1)[::-1]
        order2 = np.argsort(s2)
        sums = [0.0] * k
        sets: list[list[int]] = [[] for _ in range(k)]
        for slot, (a, b) in enumerate(zip(order1, order2)):
            sums[slot] = s1[a] + s2[b]
            sets[slot] = p1[a] + p2[b]
        spread = max(sums) - min(sums)
        heapq.heappush(heap, (-spread, tiebreak, sums, sets))
        tiebreak += 1
    _, _, sums, sets = heap[0]
    return sets


def balance_replicas(
    micro_batches: list[MicroBatch],
    dp_size: int,
    speed_factors: list[float] | None = None,
) -> list[list[MicroBatch]]:
    """Partition micro-batches across replicas minimizing max normalized load.

    Uniform speeds -> Karmarkar–Karp (paper). Non-uniform speeds (straggler
    mitigation, DESIGN §5) -> greedy LPT onto the least *normalized* load,
    so a replica at speed 0.5 receives ~half the work.
    """
    if dp_size <= 1:
        return [list(micro_batches)]
    times = [m.t for m in micro_batches]
    if speed_factors is None or len(set(speed_factors)) <= 1:
        groups = karmarkar_karp(times, dp_size)
        return [[micro_batches[i] for i in g] for g in groups]
    assert len(speed_factors) == dp_size
    loads = [0.0] * dp_size
    out: list[list[MicroBatch]] = [[] for _ in range(dp_size)]
    for i in np.argsort(times)[::-1]:
        j = int(np.argmin([(loads[r] + times[i]) / speed_factors[r]
                           for r in range(dp_size)]))
        out[j].append(micro_batches[int(i)])
        loads[j] += times[int(i)]
    return out


# ----------------------------------------------------------------------
# padding accounting (paper Fig. 15)
# ----------------------------------------------------------------------
def padding_efficiency(micro_batches: list[MicroBatch], lengths) -> float:
    L = _as2d(lengths)
    real = int(L.sum())
    padded = sum(m.padded_tokens for m in micro_batches)
    return real / max(padded, 1)
