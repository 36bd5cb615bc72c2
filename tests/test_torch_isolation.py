"""The port stands alone: no file of ``src/repro_torch/``, nor
``chip_smoke.py``, the port's examples (``examples/*_torch.py``) or
``tools/trace_report_torch.py``, imports ``jax`` or ``repro``; they import
with ``jax`` unavailable; and its entry points run on the CUDA card unless the
caller names another device — without CUDA they raise instead of running
on the CPU."""

import ast
import os
import pathlib

import pytest

torch = pytest.importorskip("torch")

import _port_session  # noqa: E402
from _port_session import port_background_jobs  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]
# the port's entry points outside the package: the examples and the tool
PORT_SCRIPTS = sorted((REPO / "examples").glob("*_torch.py")) \
    + [REPO / "tools" / "trace_report_torch.py"]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"] + PORT_SCRIPTS
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_imports(path):
    assert path.exists(), path
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


BLOCKED_IMPORTS = (
    "import sys\n"
    "for m in ('jax', 'jaxlib', 'repro'):\n"
    "    sys.modules[m] = None\n"
    "import repro_torch, repro_torch.convert, repro_torch.core, "
    "repro_torch.data, repro_torch.simulate, repro_torch.kernels\n"
    "import repro_torch.core.collaborative, repro_torch.core.consensus, "
    "repro_torch.core.primal, repro_torch.kernels.admm_update, "
    "repro_torch.kernels.round_fuse\n"
    "import repro_torch.configs, repro_torch.configs.llama3_8b, "
    "repro_torch.configs.deepseek_7b, "
    "repro_torch.configs.starcoder2_15b, "
    "repro_torch.configs.minitron_8b, "
    "repro_torch.kernels.flash_attention, "
    "repro_torch.models, repro_torch.models.attention, "
    "repro_torch.models.blocks, repro_torch.models.common, "
    "repro_torch.models.model, repro_torch.serve, "
    "repro_torch.serve.engine\n"
    "import repro_torch.core.graph_learning, repro_torch.optim, "
    "repro_torch.optim.adamw, repro_torch.models.flatten, "
    "repro_torch.tree\n"
    "import repro_torch.telemetry, repro_torch.telemetry.config, "
    "repro_torch.telemetry.frames, repro_torch.telemetry.manifest, "
    "repro_torch.telemetry.metrics, repro_torch.telemetry.report, "
    "repro_torch.experiments, repro_torch.experiments.sweep\n"
    "import repro_torch.launch, repro_torch.launch.mesh, "
    "repro_torch.launch.sharding, repro_torch.launch.shapes, "
    "repro_torch.launch.cost, repro_torch.launch.dryrun\n"
    "import importlib.util\n"
    "for path in sys.argv[1:]:\n"
    "    name = path.rsplit('/', 1)[-1][:-3]\n"
    "    spec = importlib.util.spec_from_file_location(name, path)\n"
    "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
    "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
    "               for m in sys.modules if sys.modules[m] is not None)\n"
    "print('ok')\n")


def start_blocked_imports():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return _port_session.SubprocessJob(
        BLOCKED_IMPORTS, [str(p) for p in PORT_SCRIPTS], env=env, cwd=REPO)


# a background job: it starts with the port's first test
_port_session.register(__name__, start_blocked_imports)


def test_imports_with_jax_blocked():
    """The package's modules, the examples and the tool import with
    ``jax`` and ``repro`` unavailable."""
    assert len(PORT_SCRIPTS) >= 7, PORT_SCRIPTS
    rc, log = _port_session.job(__name__).wait(timeout=120)
    assert rc == 0 and "ok" in log, log


def test_entry_points_default_to_cuda(monkeypatch):
    """Without CUDA, device=None raises — never a silent CPU run."""
    import numpy as np

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.convert import model_params_from_arrays
    from repro_torch.models import Model
    from repro_torch.convert import agent_rows_from_arrays
    from repro_torch.core import collaborative, graph, model_propagation
    from repro_torch.core.losses import pad_datasets
    from repro_torch.data import (federated_moons_problem,
                                  linear_classification_problem)
    from repro_torch.experiments import mean_estimation_trials, run_mp_sweep
    from repro_torch.telemetry import TelemetryConfig
    from repro_torch.simulate import (ScenarioSpec, get_scenario,
                                      init_sparse_admm, ring_topology,
                                      run_scenario, sparse_async_admm,
                                      sparse_async_gossip, sparse_sync_mp)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    topo = ring_topology(8)
    sol = np.zeros((8, 2), np.float32)
    c = np.ones(8, np.float32)
    g = graph.ring_graph(8)
    data = pad_datasets(list(sol[:, None, :]), device="cpu")
    calls = [
        lambda: run_scenario(ScenarioSpec(
            algo="cl", topology=topo,
            conditions=get_scenario("clean").make_conditions(4), rounds=4,
            batch=2, data=data, mu=0.1, rho=1.0, theta_sol=sol)),
        lambda: sparse_async_admm(topo, data, 0.1, 1.0, steps=2,
                                  theta_sol=sol),
        lambda: collaborative.async_admm(g, data, 0.1, 1.0, steps=2,
                                         theta_sol=sol),
        lambda: collaborative.sync_admm(g, data, 0.1, 1.0, steps=2,
                                        theta_sol=sol),
        lambda: init_sparse_admm(topo, sol),
        lambda: linear_classification_problem(n=8, p=3),
        lambda: run_scenario(ScenarioSpec(
            algo="mp", topology=topo,
            conditions=get_scenario("clean").make_conditions(4), rounds=4,
            batch=2, theta_sol=sol, c=c)),
        lambda: sparse_sync_mp(topo, sol, c, 0.9, 2),
        lambda: model_propagation.synchronous(g, sol, c, 0.9, 2),
        lambda: model_propagation.closed_form(g, sol, c, 0.9),
        lambda: model_propagation.async_gossip(g, sol, c, 0.9, 2),
        lambda: sparse_async_gossip(topo, sol, c, 0.9, 2),
        lambda: run_scenario(ScenarioSpec(
            algo="joint", topology=topo,
            conditions=get_scenario("clean").make_conditions(4), rounds=4,
            batch=2, theta_sol=sol, c=c, eta_graph=0.3)),
        lambda: run_scenario(ScenarioSpec(
            algo="mp", topology=topo,
            conditions=get_scenario("clean").make_conditions(4), rounds=4,
            batch=2, theta_sol=sol, c=c,
            telemetry=TelemetryConfig(enabled=True))),
        lambda: run_mp_sweep(mean_estimation_trials([0], [0.9], n=8),
                             sweeps=2),
        lambda: federated_moons_problem(n=4, n_test=2),
        lambda: agent_rows_from_arrays(sol),
        lambda: topo.device_tables(),
        lambda: Model(get_config("llama3-8b", "reduced")),
        lambda: model_params_from_arrays(get_config("llama3-8b", "reduced"),
                                         {}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
