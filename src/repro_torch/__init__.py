"""DynaPipe's serving and training paths ported to PyTorch and CUDA (Hopper).

A package beside ``repro`` (the JAX reference, which it never imports):

- ``repro_torch.configs``, ``core``, ``analysis``, ``data`` — copies of the
  reference's JAX-free configs, planner (palette, cost model, DP splitter,
  schedules, instruction plans, executor), plan verifier, datasets and
  streams;
- ``repro_torch.kernels`` — the attention kernels in CUDA C++ for sm_90a,
  K1 forward (``kernels/csrc/flash_fwd.cu``), K2 and K3 backward
  (``kernels/csrc/flash_bwd.cu``), their plain PyTorch versions, the
  autograd Function and the dispatch by device in ``kernels.ops``;
- ``repro_torch.models`` — the dense decoder: init, forward with
  per-period recompute, loss, prefill, decode;
- ``repro_torch.serve`` — DP request batching, prefill and greedy decode
  (``python -m repro_torch.serve``; the function is ``serve.serve``);
- ``repro_torch.train`` and ``dist`` — the grad step, AdamW and the
  plan-ahead runner on the threads backend's sequential path
  (``python -m repro_torch.launch.train``);
- ``repro_torch.convert.params_from_jax`` — reference weights into the port.

Names resolve lazily, so importing the package builds and loads nothing.
"""

_PUBLIC = {
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
