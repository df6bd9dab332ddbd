"""The PyTorch port stands alone: it imports neither JAX nor the reference
package, and its entry points never fall back to the CPU silently."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]

# One intra-op thread, here and in the subprocess, so that pytest-xdist's
# workers do not oversubscribe the CPU (idle OpenMP threads spin) and slow
# the wall-clock tests of other files.
torch.set_num_threads(1)


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def test_importing_every_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_names_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
                f"{path.name} imports {n}"


def test_entry_points_raise_without_cuda_instead_of_running_on_cpu(
        monkeypatch):
    from repro_torch import convert
    from repro_torch import serve as SV
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.models import mamba as M
    from repro_torch.models import model as MD
    from repro_torch.models import transformer as T
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_arch("gpt-paper"))
    mamba = reduced(get_arch("mamba2-130m"))
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        MD.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        T.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        M.init_mamba(torch.Generator(), mamba)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        T.init_cache(mamba, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        MD.init_params(torch.Generator(), mamba)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        SV.main(["--arch", "mamba2-130m", "--n-requests", "2"])
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        convert.params_from_jax({"w": torch.zeros(2).numpy()})
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        SV.main(["--n-requests", "2"])
    # training: the runner and the CLI default to the card too
    from repro_torch.launch import train as LT
    from repro_torch.train.runner import PlanAheadRunner, RunnerConfig
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        PlanAheadRunner(cfg, None, None, RunnerConfig(), None)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        LT.main(["--reduced", "--stages", "1", "--iters", "1"])
    # asked for explicitly, the CPU works
    assert MD.init_params(torch.Generator(), cfg, device="cpu")[
        "embed"].device.type == "cpu"


# the port's own two public names beside the reference's
PORT_NAMES = {"serve", "params_from_jax"}


def test_public_names_are_the_references_and_resolve_in_the_port():
    import repro
    import repro_torch
    assert repro_torch.__all__ == sorted(set(repro.__all__) | PORT_NAMES)
    for name in repro_torch.__all__:
        obj = getattr(repro_torch, name)
        where = getattr(obj, "__module__", None) or obj.__name__
        assert where.split(".")[0] == "repro_torch", (name, where)
        if name not in PORT_NAMES:
            # the same kind of object as the reference's: class, function
            ref = getattr(repro, name)
            assert isinstance(obj, type) == isinstance(ref, type), name
            assert obj.__name__ == ref.__name__, name
    # the mesh backend's names (ROADMAP A13) resolve in the port
    from repro_torch.dist.backend import MeshBackend
    from repro_torch.launch.mesh import make_stage_mesh
    assert repro_torch.MeshBackend is MeshBackend
    assert repro_torch.make_stage_mesh is make_stage_mesh
    with pytest.raises(AttributeError):
        repro_torch.DeviceMesh  # noqa: B018


def test_resolving_the_public_names_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch\n"
        "for n in repro_torch.__all__:\n"
        "    getattr(repro_torch, n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "print('N', len(repro_torch.__all__), 'BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert "N 21 BAD []" in out.stdout, out.stdout
