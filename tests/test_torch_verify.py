"""Strict plan verification in the port against the reference's.

The golden plans of the verifier's scenarios (gpt, t5 and mesh, the
planner over the bench's stream) verify clean in the port. Each operator
of the chaos mutation corpus, over fixed seeds, seeds one defect into a
golden plan; the port's strict ``ThreadsBackend`` and strict
``PipelineExecutor`` refuse exactly the mutants the reference's strict
``ThreadsBackend`` refuses. And ``python -m repro_torch.analysis`` writes
the reference CLI's report, byte for byte.
"""
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import __main__ as JCLI
from repro.configs.base import get_arch as j_get_arch, reduced as j_reduced
from repro.core.executor import PlanRejectedError as JRejected
from repro.core.executor import StageCallbacks as JCallbacks
from repro.dist import chaos as JC
from repro.dist.backend import ThreadsBackend as JThreads
from repro_torch.analysis import verify_plan
from repro_torch.analysis import __main__ as TCLI
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.executor import (PipelineError, PipelineExecutor,
                                       PlanRejectedError, StageCallbacks)
from repro_torch.dist import chaos as TC
from repro_torch.dist.backend import ThreadsBackend

REPO = Path(__file__).resolve().parents[1]
SCENARIOS = ("gpt", "t5", "mesh")
SEEDS = (0, 1, 2)
# the backends' model: only built, never run (the plans carry no batches)
CFG = dataclasses.replace(reduced(get_arch("gpt-paper")), n_layers=2)
JCFG = dataclasses.replace(j_reduced(j_get_arch("gpt-paper")), n_layers=2)


@functools.lru_cache(maxsize=None)
def _golden(pkg: str, name: str):
    cli = TCLI if pkg == "port" else JCLI
    plans, pal, mem = cli._golden_plans(name, 2)
    return [p for p in plans if p.micro_batches], pal, mem


@pytest.mark.parametrize("name", SCENARIOS)
def test_golden_plans_verify_clean(name):
    plans, pal, mem = _golden("port", name)
    jplans, _, _ = _golden("reference", name)
    assert [p.to_json() for p in plans] == [p.to_json() for p in jplans]
    for p in plans:
        rep = verify_plan(p, palette=pal, mem_limit=mem)
        assert not rep.findings, rep.summary()


def _noop(cls, n):
    return [cls(lambda mb, h=None: None, lambda mb, g: None, lambda: None)
            for _ in range(n)]


def _refused(run, rejected) -> bool:
    """Whether ``run()`` refuses its plan up front; a plan that gets past
    the check runs no-op callbacks and may fail otherwise (a deadlock)."""
    try:
        run()
    except rejected:
        return True
    except (PipelineError, JC.InjectedFault, RuntimeError):
        return False
    return False


@pytest.mark.parametrize("op", sorted(TC.PLAN_MUTATIONS))
def test_strict_mode_refuses_the_mutants_the_reference_refuses(op):
    assert sorted(TC.PLAN_MUTATIONS) == sorted(JC.PLAN_MUTATIONS)
    n_mutants = n_refused = 0
    for name in SCENARIOS:
        plans, _, _ = _golden("port", name)
        jplans, _, _ = _golden("reference", name)
        for k, (plan, jplan) in enumerate(zip(plans, jplans)):
            for seed in SEEDS:
                t, j = (TC.mutate_plan(plan, op, seed=seed),
                        JC.mutate_plan(jplan, op, seed=seed))
                assert (t is None) == (j is None)
                if t is None:
                    continue
                (mutant, desc), (jmutant, jdesc) = t, j
                assert desc == jdesc and mutant.to_json() == jmutant.to_json()
                n_mutants += 1
                c = mutant.n_stages
                ref = _refused(lambda: JThreads(
                    JCFG, c, use_executor=False, strict=True).execute_plan(
                        jmutant, callbacks=_noop(JCallbacks, c), timeout=0.5),
                    JRejected)
                backend = _refused(lambda: ThreadsBackend(
                    CFG, c, use_executor=False, strict=True,
                    device="cpu").execute_plan(
                        mutant, callbacks=_noop(StageCallbacks, c),
                        timeout=0.5), PlanRejectedError)
                executor = _refused(lambda: PipelineExecutor(
                    mutant, _noop(StageCallbacks, c), timeout=0.5,
                    strict=True).run(), PlanRejectedError)
                assert backend == executor == ref, \
                    f"[{name} plan {k} seed {seed}] {desc}: reference " \
                    f"{ref}, backend {backend}, executor {executor}"
                n_refused += ref
    assert n_mutants > 0 and n_refused > 0


def test_cli_writes_the_references_report(tmp_path):
    args = ["--scenario", "all", "--naive-demo", "--mutations", "14",
            "--out"]
    outs = {}
    for pkg in ("repro_torch", "repro"):
        out = tmp_path / f"{pkg}.json"
        r = subprocess.run([sys.executable, "-m", f"{pkg}.analysis", *args,
                            str(out)], capture_output=True, text=True,
                           timeout=300,
                           env={"PYTHONPATH": str(REPO / "src"),
                                "PATH": "/usr/bin:/bin",
                                "JAX_PLATFORMS": "cpu"})
        assert r.returncode == 0, r.stderr
        outs[pkg] = out.read_text()
    # the report has no wall-time field: byte for byte
    assert outs["repro_torch"] == outs["repro"]
    report = json.loads(outs["repro_torch"])
    assert report["mutations"]["kill_rate"] == 1.0
    assert all(s["errors"] == 0 for s in report["scenarios"])
