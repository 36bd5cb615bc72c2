"""Process set-up shared by the port's test modules (tests/test_torch_*.py).

* Torch runs on one CPU thread in these tests.  Their tensors are small,
  so an op's fan-out over the cores costs more than it saves, and far
  more when other processes share the cores.  The gloo ranks the tests
  spawn set the same, so that what they compute bit for bit against the
  parent process is computed the same way.
* Background jobs.  A test module that needs other processes (a gloo
  process group, a JAX subprocess, the JAX side of its comparisons run
  in a process of its own: :class:`ReferenceJob`) registers a job here
  when it is imported.  The first port test to run queues the job of
  every module that has a selected test, in the order the modules run
  (the long ones registered ``first`` ahead), and a thread starts them,
  at most ``MAX_PROCS`` processes at a time (the cores but one), so that
  they run beside the tests before their module; the module's own test
  or fixture then waits for the job's result (and starts it at once if
  it is still queued).  Every job still running when the session ends is
  killed, and its files are removed.

Each test module imports :func:`port_background_jobs` (an autouse
fixture) from here.
"""

import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import pytest
import torch

torch.set_num_threads(1)

# background processes at a time: the cores but the test process's, seven
# on an 8-core host
MAX_PROCS = max(1, len(os.sched_getaffinity(0)) - 1)
_JOBS = {}           # (module name, job name) -> (start(), processes);
#                      start() returns an object with done() and stop()
_RUNNING = {}        # (module name, job name) -> the started job
_QUEUE = []          # jobs not started yet, in the order their modules run
_LOCK = threading.RLock()
_STOP = threading.Event()    # set when the session ends
_SESSION = {"started": False}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, fn, nprocs: int, port: int, out_dir: str):
    """A spawned rank: its output to ``rank<r>.log`` under ``out_dir``
    (never into the parent's terminal, where it would split pytest's
    progress lines), then ``fn(rank, nprocs, port, out_dir)``."""
    log = os.open(os.path.join(out_dir, f"rank{rank}.log"),
                  os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    os.dup2(log, 1)
    os.dup2(log, 2)
    fn(rank, nprocs, port, out_dir)


class SpawnJob:
    """``nprocs`` ranks of ``fn(rank, nprocs, port, out_dir)`` in spawned
    processes (``torch.multiprocessing.spawn``); each rank saves
    ``rank<r>.pt`` under ``out_dir``."""

    def __init__(self, fn, nprocs: int):
        import torch.multiprocessing as mp
        self.nprocs = nprocs
        self.tmp = tempfile.mkdtemp(prefix="port-spawn-")
        self.ctx = mp.spawn(_rank_entry,
                            args=(fn, nprocs, free_port(), self.tmp),
                            nprocs=nprocs, join=False)

    def results(self, timeout: float) -> list:
        """Every rank's saved results, waiting at most ``timeout`` seconds
        for the ranks to finish."""
        deadline = time.monotonic() + timeout
        try:
            while not self.ctx.join(
                    timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {self.nprocs} ranks did not "
                                       f"finish in {timeout:g} s")
        except Exception as e:
            logs = "".join(
                open(os.path.join(self.tmp, f"rank{r}.log")).read()[-3000:]
                for r in range(self.nprocs)
                if os.path.exists(os.path.join(self.tmp, f"rank{r}.log")))
            raise RuntimeError(f"{e}\nthe ranks' output:\n{logs}") from e
        finally:
            self.stop(remove=False)
        return [torch.load(os.path.join(self.tmp, f"rank{r}.pt"))
                for r in range(self.nprocs)]

    def done(self) -> bool:
        return all(proc.exitcode is not None for proc in self.ctx.processes)

    def stop(self, remove: bool = True):
        for proc in self.ctx.processes:
            if proc.is_alive():
                proc.kill()
        if remove:
            shutil.rmtree(self.tmp, ignore_errors=True)


class SubprocessJob:
    """``python -c code *args`` with ``env``; ``{out}`` in ``args`` is a
    file path under the job's own temporary directory."""

    def __init__(self, code: str, args=(), env=None, cwd=None):
        self.tmp = tempfile.mkdtemp(prefix="port-subproc-")
        self.out = os.path.join(self.tmp, "out")
        self.log = open(os.path.join(self.tmp, "log"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code]
            + [a.format(out=self.out) for a in args],
            env=env, cwd=cwd, stdout=self.log, stderr=subprocess.STDOUT,
            text=True)

    def done(self) -> bool:
        return self.proc.poll() is not None

    def wait(self, timeout: float):
        """``(returncode, output)`` once the process ends, waiting at most
        ``timeout`` seconds."""
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
        self.log.seek(0)
        return rc, self.log.read()

    def stop(self, remove: bool = True):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()
        if remove:
            shutil.rmtree(self.tmp, ignore_errors=True)


class ReferenceJob(SubprocessJob):
    """``module.function()`` (a test module's own function, typically the
    JAX side of its comparisons) in a subprocess, its return value
    pickled: numpy arrays, dicts, lists, numbers.  The subprocess imports
    the test module as the parent does, from the tests' directory."""

    def __init__(self, module: str, function: str):
        code = ("import pickle, sys\n"
                f"import {module} as m\n"
                f"out = m.{function}()\n"
                "with open(sys.argv[1], 'wb') as f:\n"
                "    pickle.dump(out, f)\n")
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [here, os.path.join(os.path.dirname(here), "src"),
             env.get("PYTHONPATH", "")])
        super().__init__(code, ["{out}"], env=env)
        self._result = None

    def result(self, timeout: float = 600):
        """The function's return value, waiting at most ``timeout``
        seconds for the subprocess."""
        if self._result is None:
            rc, log = self.wait(timeout)
            if rc != 0:
                raise RuntimeError(f"the reference subprocess exited {rc}:"
                                   f"\n{log[-6000:]}")
            with open(self.out, "rb") as f:
                self._result = pickle.load(f)
        return self._result


def register(module: str, start, name: str = "", nprocs: int = 1,
             first: bool = False) -> None:
    """Register ``start()`` as background job ``name`` of test module
    ``module`` (its ``__name__``), a job of ``nprocs`` processes;
    ``first`` queues it ahead of the module order (a job long enough to
    be late for its module otherwise)."""
    _JOBS[module, name] = (start, nprocs, first)


def reference_fixture(module: str, first: bool = False):
    """Register test module ``module``'s ``jax_references()`` as its
    background :class:`ReferenceJob` and return the module-scoped fixture
    ``refs`` that waits for its result; a module binds it as
    ``refs = _port_session.reference_fixture(__name__)``."""
    register(module, lambda: ReferenceJob(module, "jax_references"),
             first=first)

    @pytest.fixture(scope="module")
    def refs():
        return job(module).result()
    return refs


def as_numpy(tree):
    """``tree`` with every leaf a numpy array (JAX's results, carried out
    of its subprocess by pickle)."""
    import jax
    import numpy as np
    return jax.tree_util.tree_map(np.asarray, tree)


def job(module: str, name: str = ""):
    """Job ``name`` of ``module``, started now if it has not been."""
    with _LOCK:
        key = (module, name)
        if key not in _RUNNING:
            if key in _QUEUE:
                _QUEUE.remove(key)
            _RUNNING[key] = _JOBS[key][0]()
        return _RUNNING[key]


def _schedule():
    """Start the queued jobs in the order their modules run, at most
    ``MAX_PROCS`` of their processes at a time (one job at any rate).

    The thread lives until the session ends: a process that
    ``torch.multiprocessing.spawn`` starts gets SIGINT when the thread
    that started it exits (``PR_SET_PDEATHSIG``), and a rank that gets it
    exits 0 without its results."""
    while not _STOP.is_set():
        with _LOCK:
            if not _QUEUE:
                break
            busy = sum(_JOBS[key][1] for key, j in _RUNNING.items()
                       if not j.done())
            key = _QUEUE[0]
            if busy == 0 or busy + _JOBS[key][1] <= MAX_PROCS:
                _QUEUE.pop(0)
                _RUNNING[key] = _JOBS[key][0]()
                continue
        _STOP.wait(0.2)
    _STOP.wait()


@pytest.fixture(autouse=True, scope="session")
def port_background_jobs(request):
    """Queue the registered jobs of the selected modules at the first port
    test, in the order the modules run; stop whatever still runs at the
    end of the session."""
    if not _SESSION["started"]:
        _SESSION["started"] = True
        order = list(dict.fromkeys(
            item.module.__name__ for item in request.session.items
            if getattr(item, "module", None) is not None))
        queued = [key for module in order for key in _JOBS
                  if key[0] == module]
        _QUEUE.extend(sorted(queued, key=lambda key: not _JOBS[key][2]))
        threading.Thread(target=_schedule, daemon=True).start()
    yield
    with _LOCK:
        _QUEUE.clear()
        while _RUNNING:
            _RUNNING.popitem()[1].stop()
    _STOP.set()
