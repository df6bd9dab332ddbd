"""DynaPipe serving path ported to PyTorch and CUDA (Hopper).

A package beside ``repro`` (the JAX reference, which it never imports):

- ``repro_torch.configs``, ``core``, ``data`` — copies of the reference's
  JAX-free configs, shape palette, cost model, DP splitter and dataset;
- ``repro_torch.kernels`` — attention kernel K1 in CUDA C++ for sm_90a
  (``kernels/csrc/flash_fwd.cu``), its plain PyTorch version, and the
  dispatch by device in ``kernels.ops``;
- ``repro_torch.models`` — the dense decoder: init, forward, prefill, decode;
- ``repro_torch.serve`` — DP request batching, prefill and greedy decode
  (``python -m repro_torch.serve``; the function is ``serve.serve``);
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
