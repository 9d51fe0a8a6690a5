"""The port's entry points (``dagr_tpu_torch.entry``) against dagr_tpu's
``__graft_entry__``.

``entry(device="cpu", tiny=True)``: its compiled eval forward (eager on
the CPU) on its own window, with dagr_tpu's init of
``__graft_entry__._flagship(tiny=True)`` carried into the state, against
that model's jitted apply on the same window (raw 1e-4); the flagship
shapes of ``_flagship()`` equal dagr_tpu's; ``entry()`` stops where no
card is found.  ``dryrun_multichip(2)`` in a fresh process with no
environment help (every rank's train, eval and serve legs checked
against one process inside); ``dryrun_multichip(8)`` is ``slow``, as
dagr_tpu's is (tests/test_entry.py).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dagr_tpu.data.synthetic import random_events as jax_random_events
from dagr_tpu_torch import entry
from dagr_tpu_torch.models.bridge import from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import __graft_entry__ as graft  # noqa: E402


@pytest.mark.parametrize("tiny", [True, False])
def test_flagship_shapes_match(tiny):
    _, cfg, H, W = entry._flagship(tiny)
    _, jcfg, jH, jW = graft._flagship(tiny)
    assert (H, W) == (jH, jW)
    for f in ("n_nodes", "max_neighbors", "batch_size", "radius",
              "base_width", "num_scales", "pooling_dim_at_output"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_entry_tiny_matches_graft_forward():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fn, (state, events) = entry.entry(device="cpu", tiny=True)
        model, cfg, H, W = graft._flagship(tiny=True)
        ev = jax_random_events(np.random.default_rng(entry.SEED), 1,
                               cfg.n_nodes, width=W, height=H,
                               n_valid=entry.TINY_VALID)
        np.testing.assert_array_equal(np.asarray(ev.pos),
                                      events.pos.numpy())
        variables = jax.jit(lambda k, e: model.init(k, e, train=False))(
            jax.random.key(0), ev)
        sd = from_flax(variables)
        state.model.load_state_dict(sd)
        state.ema.load_state_dict(sd)
        want = np.asarray(jax.jit(lambda v, e: model.apply(
            v, e, train=False))(variables, ev))
        raw = fn(state, events)
    finally:
        torch.set_num_threads(n)
    assert raw.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(raw.numpy(), want, atol=1e-4, rtol=1e-4)
    assert float(np.abs(want).max()) > 0


def test_entry_stops_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()


def _dryrun(n, timeout):
    code = f"from dagr_tpu_torch import entry; entry.dryrun_multichip({n})"
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert f"dryrun_multichip({n}): ok" in r.stdout, r.stdout
    assert "== one process" in r.stdout


def test_dryrun_multichip_2_subprocess():
    _dryrun(2, timeout=300)


@pytest.mark.slow
def test_dryrun_multichip_8_subprocess():
    _dryrun(8, timeout=1200)
