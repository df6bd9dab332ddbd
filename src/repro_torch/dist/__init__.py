"""``repro_torch.dist`` — the distributed execution substrate.

Counterpart of ``repro.dist``. Everything above this package plans in
*logical* terms (micro-batches, instruction streams); everything below it
is devices, threads and processes. Its modules:

- :mod:`repro_torch.dist.backend` — the :class:`ExecutionBackend` protocol
  behind ``execute_plan``: ``"threads"`` (the sequential grad loop or the
  threaded stage pipeline, one CUDA stream per stage) and ``"mesh"`` (the
  shift register over a stage mesh, ZeRO-1 optimizer state).
- :mod:`repro_torch.dist.pipeline` — the device plane's GPipe shift
  register (``pipelined_apply``, ``pipelined_grads``) over a stage mesh,
  and the plan's injection order.
- :mod:`repro_torch.dist.sharding` — logical-axis resolution
  (``spec_for``, ZeRO-1's ``zero1_logical``), the port's ``Mesh`` and the
  ambient mesh, and ``shard``, the layout change inside a shard group.
- :mod:`repro_torch.dist.spmd` — the shard group: sharding inside a stage
  over a (data, model) mesh from one controller in lockstep
  (``Sharded`` values, ordered collectives, ``value_and_grad``, the
  attention merge of a KV cache split by sequence); the training step,
  prefill and decode with sharded KV and Mamba caches, and the token,
  frames and mixed inputs run there, Mamba's tensor parallelism and
  ZeRO-3 weights included, on devices or, for a dry run, on ``meta``.
  T5 there is the decoder-only stack at its widths, as in the reference.
- :mod:`repro_torch.dist.fault` — heartbeat/straggler monitoring and
  elastic re-planning over the surviving replica set.
- :mod:`repro_torch.dist.chaos` — deterministic fault injection (seeded,
  replayable fault traces) for the recovery tests.
- :mod:`repro_torch.dist.cluster` — the process fault domain: one OS
  process per DP replica, socket heartbeats, coordinator election, kill -9
  recovery (``RunnerConfig.fault_domain="process"``).
"""
from repro_torch.dist import chaos, fault  # noqa: F401


def __getattr__(name):
    # backend imports the training step (models, kernels), and cluster
    # reaches backend and runner internals at call time: both load on
    # first access, so importing the package stays cheap
    if name == "backend":
        import repro_torch.dist.backend as backend
        return backend
    if name == "cluster":
        import repro_torch.dist.cluster as cluster
        return cluster
    raise AttributeError(f"module 'repro_torch.dist' has no attribute {name!r}")
