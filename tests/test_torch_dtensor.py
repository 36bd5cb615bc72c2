"""The model's DTensor forms against its plain forms, with real values.

The dry run traces the model on ``meta`` tensors, so it checks shapes and
counts, not values.  Here two gloo ranks (tests/_dtensor_worker.py) lay
every reduced family's weights out by its specs over a 2-wide "model"
axis, in float32, and hold each against the plain run on the same
values (1e-5, absolute, on values of order 1):

* train: the loss and every gradient (``loss_parallel``, the head split
  and merge, attention on each device's own heads, the sequence-parallel
  gathers and scatters), then two whole train steps (``adamw_update_`` on
  laid-out gradients, the anchor's EMA, the dense mp coupling through
  ``launch.mesh.AgentMesh``): parameters, moments and gradient norm;
* serve: ``prefill`` into a long cache and into a ring, then one
  ``decode_step`` (the whole-tensor cache writes), the last logits of
  each.
"""

import os
import socket
import tempfile
import time

import pytest

torch = pytest.importorskip("torch")

import _dtensor_worker as dw  # noqa: E402

TOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results, from one spawn of the gloo group."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(dw.rank_main, args=(dw.WORLD, _free_port(), tmp),
                       nprocs=dw.WORLD, join=False)
        deadline = time.monotonic() + 120
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError("the gloo ranks did not finish in "
                                       "120 s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for r in range(dw.WORLD)]


@pytest.mark.parametrize("arch", dw.FAMILIES)
def test_dtensor_train_equals_plain(ranks, arch):
    for out in ranks:
        got = out[arch]["train"]
        assert got["grads_are_dtensors"]
        assert got["loss_err"] <= TOL, got
        assert got["grad_err"] <= TOL, got
        assert got["step_param_moved"] > 0, got
        assert got["step_param_err"] <= TOL, got
        assert got["step_moment_err"] <= TOL, got
        assert got["step_grad_norm_err"] <= TOL, got
    assert ranks[0][arch]["train"] == ranks[1][arch]["train"]


@pytest.mark.parametrize("arch", dw.FAMILIES)
def test_dtensor_prefill_and_decode_equal_plain(ranks, arch):
    for out in ranks:
        got = out[arch]["serve"]
        assert got["caches_are_dtensors"]
        assert got["logit_max"] > 1.0, got
        assert got["prefill_err"] <= TOL, got
        assert got["decode_err"] <= TOL, got
    assert ranks[0][arch]["serve"] == ranks[1][arch]["serve"]
