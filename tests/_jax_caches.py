"""Shared fixture of the tests that hold the PyTorch port against JAX.

These modules run last in one long pytest process, after the JAX
package's own tests have compiled thousands of XLA programs.  Each compiled
program holds a few memory maps, and a process that keeps them all runs
into Linux's ``vm.max_map_count`` (65530), where XLA's next compile
crashes the process.  Importing :func:`fresh_jax_caches` into a test module
drops every cached program when the module starts and when it ends.
"""

import gc

import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def fresh_jax_caches():
    jax.clear_caches()
    gc.collect()
    yield
    jax.clear_caches()
    gc.collect()
