"""The port's example (``examples/personalized_lm_torch.py``, the
counterpart of ``examples/personalized_lm.py``) runs in process at its
tiny size on the CPU, through its own ``main``: two agents, two steps of
the ``none`` and ``mp`` modes, finite losses, and the final table
printed."""

import importlib.util
import math
import pathlib

import pytest

torch = pytest.importorskip("torch")

from _port_session import port_background_jobs  # noqa: E402,F401

EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "examples" \
    / "personalized_lm_torch.py"


def load_example():
    spec = importlib.util.spec_from_file_location("personalized_lm_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_runs_tiny_on_the_cpu(capsys):
    example = load_example()
    results = example.main(["--tiny", "--device", "cpu", "--agents", "2",
                            "--steps", "2", "--modes", "none,mp"])
    out = capsys.readouterr().out
    assert set(results) == {"none", "mp"}
    assert all(math.isfinite(v) for v in results.values())
    assert "model: plm-tiny" in out and "on cpu" in out
    for mode in ("none", "mp"):
        assert f"[{mode}] step     1" in out
        assert f"{mode:10s} final loss {results[mode]:.4f}" in out
    summary = out[out.index("summary (lower = better personalization):"):]
    rows = [line.split() for line in summary.splitlines()[1:] if line]
    assert [r[0] for r in rows] == sorted(results, key=results.get)
    assert [float(r[1]) for r in rows] == \
        sorted(round(v, 4) for v in results.values())


def test_example_needs_a_card_unless_asked_for_the_cpu():
    example = load_example()
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.main(["--tiny", "--agents", "2", "--steps", "1",
                      "--modes", "none"])
