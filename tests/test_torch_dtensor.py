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

import pytest

torch = pytest.importorskip("torch")

import _dtensor_worker as dw  # noqa: E402
import _port_session  # noqa: E402
from _port_session import port_background_jobs  # noqa: E402,F401

TOL = 1e-5

# the gloo group runs as a background job, beside the tests before this
# module
_port_session.register(__name__, lambda: _port_session.SpawnJob(
    dw.rank_main, dw.WORLD), nprocs=dw.WORLD)


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results, from one spawn of the gloo group."""
    return _port_session.job(__name__).results(timeout=120)


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
