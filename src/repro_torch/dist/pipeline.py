"""Pipeline-parallel execution over a stage mesh (paper §5–§6).

Counterpart of ``repro.dist.pipeline``. Two execution planes implement the
same instruction semantics:

- **Host plane** (``core/executor.py``): one Python thread per stage
  interprets an :class:`~repro_torch.core.instructions.ExecutionPlan`
  against rendezvous channels; ragged micro-batches, each its own shape.
  :func:`execute_plan` is that entry point.
- **Device plane** (:func:`pipelined_apply`, :func:`pipelined_grads`): a
  GPipe shift register over a stage mesh
  (:func:`repro_torch.launch.mesh.make_stage_mesh`). With ``S`` stages
  and ``M`` micro-batches it runs ``M + S - 1`` ticks; at tick ``t`` stage
  ``s`` holds micro-batch ``t - s`` on its own device, computes, and hands
  its output to stage ``s + 1``. Micro-batches enter the ring in the order
  they are given, which the mesh backend takes from the plan
  (:func:`injection_order`, the §6 comm plan's order).

Where the reference compiles the ring into one ``shard_map`` program (SPMD
over the mesh, the hand-off a ``ppermute``), the port is a single
controller: the ticks are an eager host loop over ``mesh.devices``, and a
hand-off is a copy onto the next stage's device. On one device (a mesh
may repeat one card) the copy is the tensor itself: nothing writes a
sent tensor afterwards. On several cards it is a peer copy.

The reference's stage program is uniform: every stage embeds, runs its
slice, norms and takes the loss, and ``jnp.where`` masks pick its role;
warm-up and drain ticks compute on values that never reach a valid slot.
Those masked terms add exact zeros, so the port instead runs only each
stage's own role (stage 0 embeds, only the last stage norms and takes the
loss) and runs nothing on warm-up and drain ticks; the results are the
same. The reference's ``psum`` over the stage axis is a sum in ascending
stage order on stage 0's device (the mesh backend's merge).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.executor import PipelineExecutor, StageCallbacks
from repro_torch.core.instructions import ExecutionPlan, Op
from repro_torch.dist.sharding import Mesh
from repro_torch.tree import add_into, leaves, tree_map


def injection_order(plan: ExecutionPlan) -> list[int]:
    """Micro-batch ids in the order stage 0 launches forwards: the ring
    entry order the §6 comm plan proved deadlock-free. The planner's
    ``plan.meta["injection_order"]`` (the schedule's cluster-permuted
    order) wins when present; a hand-built plan falls back to a scan of
    stage 0's instruction stream, which can break launch-time ties
    differently."""
    meta_order = plan.meta.get("injection_order") if plan.meta else None
    if meta_order:
        return [int(i) for i in meta_order]
    return [ins.micro_batch for ins in plan.per_stage[0]
            if ins.op is Op.FORWARD]


def stage_devices(mesh: Mesh, n_stages: int) -> list[torch.device]:
    """Stage ``s``'s device: the first of row ``s`` of the mesh's first
    (stage) axis. Further axes hold replicas, as in the reference, whose
    ``shard_map`` places the stack ``P(stage)`` and runs each stage with
    no ambient mesh: every device of a row computes the same values, so
    one of them stands for the row."""
    axis = mesh.axis_names[0]
    if mesh.devices is None:
        raise ValueError(f"{mesh} is abstract: a pipeline needs devices")
    if mesh.shape[axis] != n_stages:
        raise ValueError(
            f"stage axis {axis!r} has size {mesh.shape[axis]}, expected "
            f"n_stages={n_stages}")
    rest = (0,) * (mesh.devices.ndim - 1)
    return [mesh.devices[(s,) + rest] for s in range(n_stages)]


def _sequential(stage_fn, stage_params, xs, n_stages):
    """One device, no hand-offs: the same math."""
    h = list(xs)
    for s in range(n_stages):
        w = tree_map(lambda a, s=s: a[s], stage_params)
        h = [stage_fn(w, hb, s) for hb in h]
    return torch.stack(h)


def pipelined_apply(stage_fn: Callable, stage_params, inputs: torch.Tensor,
                    *, mesh: Optional[Mesh] = None,
                    n_stages: Optional[int] = None,
                    plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
    """Run ``inputs`` through ``n_stages`` pipeline stages on ``mesh``.

    ``stage_fn(stage_weights, h, stage) -> h_out`` transforms one
    micro-batch, shape and dtype kept; ``stage_params`` is a tree whose
    leaves carry a leading ``n_stages`` axis (stage ``s`` computes with
    leaf ``[s]``, placed on its device); ``inputs`` is an ``(n_micro,
    micro_batch, ...)`` stack. ``mesh=None`` or a 1-stage mesh runs the
    sequential fallback. ``plan`` fixes the ring entry order
    (:func:`injection_order`); the result is in the original micro-batch
    order regardless, on the inputs' device."""
    if n_stages is None:
        n_stages = (mesh.shape[mesh.axis_names[0]] if mesh is not None
                    else leaves(stage_params)[0].shape[0])
    n_micro = inputs.shape[0]
    order = None
    if plan is not None:
        if plan.n_stages != n_stages:
            raise ValueError(f"plan has {plan.n_stages} stages, mesh/params "
                             f"give {n_stages}")
        order = np.asarray(injection_order(plan))
        if sorted(order.tolist()) != list(range(n_micro)):
            raise ValueError("plan injection order does not cover inputs")
        inputs = inputs[torch.as_tensor(order)]

    if mesh is None or mesh.shape[mesh.axis_names[0]] <= 1:
        out = _sequential(stage_fn, stage_params, inputs, n_stages)
    else:
        devs = stage_devices(mesh, n_stages)
        w = [tree_map(lambda a, s=s: a[s].to(devs[s]), stage_params)
             for s in range(n_stages)]
        outs: list = [None] * n_micro
        buf: list = [None] * n_stages
        for t in range(n_micro + n_stages - 1):
            nxt: list = [None] * n_stages
            for s in range(n_stages):
                m = t - s
                if not 0 <= m < n_micro:
                    continue          # warm-up / drain: nothing to run
                x = inputs[m].to(devs[0]) if s == 0 else buf[s]
                h = stage_fn(w[s], x, s)
                if s == n_stages - 1:
                    outs[m] = h.to(inputs.device)
                else:
                    nxt[s + 1] = h.to(devs[s + 1])        # the hand-off
            buf = nxt
        out = torch.stack(outs)
    if order is not None:
        out = out[torch.as_tensor(np.argsort(order))]
    return out


def pipelined_grads(stage_steps: list, stage_params: list,
                    batch_stack: list, *, mesh: Mesh, n_stages: int):
    """Forward **and backward** GPipe shift register: the loss and the
    parameter gradients of a stack of micro-batches.

    ``M`` micro-batches ride an ``M + S - 1``-tick forward ring in the
    order of ``batch_stack`` (the injection order), each stage stashing
    its *input*; then an equally long backward ring runs the other way:
    at tick ``u`` stage ``s`` takes micro-batch ``u - (S - 1 - s)``,
    recomputes its stage forward from the stash with gradients on
    (stage-granular checkpointing, the host plane's policy) and hands the
    input's gradient to stage ``s - 1``.

    Args:
      stage_steps: stage ``s``'s ``(forward, backward)``:
        ``forward(w, x, batch)`` -> the stage output, or ``(loss_sum,
        weight_sum)`` on the last stage, stage 0's ``x`` being its batch;
        ``backward(w, x, g, batch)`` -> ``(param grads, input grads)``,
        ``g`` None on the last stage (its loss gets cotangent 1), the input
        grads None on stage 0.
      stage_params: stage ``s``'s parameter tree, on its device.
      batch_stack: the micro-batch dicts in ring order, tensors on any
        device (each stage reads its copy on its own device).
      mesh: the stage mesh (first axis of size ``n_stages``).

    Returns ``(loss_vec, weight_vec, stage_grads)``: per micro-batch, in
    ``batch_stack``'s order, the loss and weight sums (0-d tensors on the
    last stage's device), and per stage the gradient tree of its params,
    the micro-batches' gradients added in ring order.
    """
    devs = stage_devices(mesh, n_stages)
    n_micro = len(batch_stack)
    last = n_stages - 1
    n_ticks = n_micro + n_stages - 1
    on_dev = {d: [{k: v.to(d) for k, v in b.items()} for b in batch_stack]
              for d in set(devs)}

    def batch(s, m):
        return on_dev[devs[s]][m]

    # ------------------------- forward ring -------------------------
    stash = [[None] * n_micro for _ in range(n_stages)]
    loss_vec: list = [None] * n_micro
    w_vec: list = [None] * n_micro
    buf: list = [None] * n_stages
    for t in range(n_ticks):
        nxt: list = [None] * n_stages
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            x = batch(s, m) if s == 0 else buf[s]
            stash[s][m] = x
            out = stage_steps[s][0](stage_params[s], x, batch(s, m))
            if s == last:
                loss_vec[m], w_vec[m] = out
            else:
                nxt[s + 1] = out.to(devs[s + 1])
        buf = nxt

    # ------------------------- backward ring ------------------------
    grads: list = [None] * n_stages
    gbuf: list = [None] * n_stages
    for u in range(n_ticks):
        nxt = [None] * n_stages
        for s in range(n_stages):
            m = u - (last - s)
            if not 0 <= m < n_micro:
                continue
            x, stash[s][m] = stash[s][m], None
            g = None if s == last else gbuf[s]
            gw, gx = stage_steps[s][1](stage_params[s], x, g, batch(s, m))
            grads[s] = gw if grads[s] is None else add_into(grads[s], gw)
            if s > 0:
                nxt[s - 1] = gx.to(devs[s - 1])
        gbuf = nxt
    return loss_vec, w_vec, grads


def execute_plan(plan: ExecutionPlan, callbacks: list[StageCallbacks],
                 timeout: float = 60.0) -> None:
    """Host-plane entry point: interpret a (possibly ragged) plan with the
    threaded stage executor. ``ThreadsBackend.execute_plan(plan,
    callbacks=...)`` is the same call through the backend protocol."""
    PipelineExecutor(plan, callbacks, timeout=timeout).run()
