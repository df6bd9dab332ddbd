"""DynaPipe's training and serving paths ported to PyTorch and CUDA (Hopper).

A package beside ``repro`` (the JAX reference, which it never imports):

- ``repro_torch.configs``, ``core``, ``analysis``, ``data`` — copies of the
  reference's JAX-free configs, planner (palette, cost model, DP splitter,
  schedules, instruction plans, executor), plan verifier, datasets and
  streams;
- ``repro_torch.kernels`` — hand-written CUDA C++ kernels for sm_90a: K1,
  the attention forward (``kernels/csrc/flash_fwd.cu``, a prefill and a
  decode form), one fused attention backward doing the work of the
  reference's K2 and K3 (``kernels/csrc/flash_bwd.cu``), and K4, Mamba2's
  SSD (``kernels/csrc/ssd_fwd.cu``); their plain PyTorch versions, the
  autograd Function and the dispatch by device in ``kernels.ops``;
- ``repro_torch.models`` — the model zoo: dense, MoE, Mamba2 and hybrid
  decoders, the T5 encoder-decoder, frame and mixed input modes; init,
  forward with per-period recompute, loss, prefill, decode;
- ``repro_torch.serve`` — DP request batching, prefill and greedy decode
  (``python -m repro_torch.serve``; the function is ``serve.serve``);
- ``repro_torch.train`` and ``dist`` — the grad step, AdamW, format-2
  checkpoints, and the plan-ahead runner on the threads backend (the
  sequential grad loop or the threaded stage pipeline) or the mesh
  backend (the shift register over a stage mesh, ZeRO-1 optimizer
  state), with in-process fault recovery and the process fault domain
  (``dist.cluster``) (``python -m repro_torch.launch.train``); the
  logical sharding rules (``dist.sharding``) and the train state's spec
  trees (``train.train_state``);
- ``repro_torch.convert.params_from_jax`` — reference weights into the port.

The public surface re-exports lazily (PEP 562): the reference's names,
plus ``serve`` and ``params_from_jax``. Importing the package builds and
loads nothing::

    from repro_torch import PlanAheadRunner, RunnerConfig, make_backend
"""

# public name -> defining module; resolved on first attribute access
_PUBLIC = {
    # execution backends (the ExecutionBackend protocol)
    "ExecutionBackend": "repro_torch.dist.backend",
    "ThreadsBackend": "repro_torch.dist.backend",
    "MeshBackend": "repro_torch.dist.backend",
    "make_stage_mesh": "repro_torch.launch.mesh",
    "BackendResult": "repro_torch.dist.backend",
    "make_backend": "repro_torch.dist.backend",
    # planning
    "PlannerConfig": "repro_torch.core.planner",
    "plan_iteration": "repro_torch.core.planner",
    "ExecutionPlan": "repro_torch.core.instructions",
    "ShapePalette": "repro_torch.core.microbatch",
    "AnalyticCostModel": "repro_torch.core.cost_model",
    # training runtime
    "PlanAheadRunner": "repro_torch.train.runner",
    "RunnerConfig": "repro_torch.train.runner",
    "CompiledStepCache": "repro_torch.train.step_cache",
    "AdamWConfig": "repro_torch.train.optimizer",
    # data
    "MultiTaskStream": "repro_torch.data.streams",
    "StreamConfig": "repro_torch.data.streams",
    # model zoo
    "get_arch": "repro_torch.configs.base",
    "reduced": "repro_torch.configs.base",
    # the port's own
    "serve": "repro_torch.serve",
    "params_from_jax": "repro_torch.convert",
}

__all__ = sorted(_PUBLIC)


def __getattr__(name):
    import importlib
    mod = _PUBLIC.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    if name == "serve":
        return importlib.import_module(mod)
    return getattr(importlib.import_module(mod), name)
