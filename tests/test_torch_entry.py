"""The port's entry points (``cubicsdr_tpu_torch/entry.py``) against the
JAX package's ``__graft_entry__.py`` on the CPU: ``entry()``'s step at
the JAX entry's block length, at the pipeline's gates (audio rms < 2e-3
and 99.5% quantile < 5e-3, levels within 0.05; tests/test_fused_route.py),
and ``dryrun_multichip`` re-exported."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import __graft_entry__ as j_entry  # noqa: E402

from cubicsdr_tpu_torch import entry as entry_mod  # noqa: E402
from cubicsdr_tpu_torch.entry import entry  # noqa: E402


def test_entry_matches_jax_entry():
    """The same seed-0 IQ and controls, one jitted JAX step against one
    port step on the CPU (the JAX entry builds without its kernels, so
    its block length is passed to the port's)."""
    jfn, (jstate, jiq) = j_entry.entry()
    _, j_mix, j_level = jax.jit(jfn)(jstate, jiq)
    fn, (state, iq) = entry("cpu", block_len=len(jiq.re))
    np.testing.assert_array_equal(iq.re.numpy(), np.asarray(jiq.re))
    np.testing.assert_array_equal(iq.im.numpy(), np.asarray(jiq.im))
    new_state, mix, level = fn(state, iq)
    assert mix.shape == np.shape(j_mix) and level.shape == (16,)
    d = np.abs(mix.numpy() - np.asarray(j_mix))
    assert np.sqrt(np.mean(d * d)) < 2e-3, np.sqrt(np.mean(d * d))
    assert np.quantile(d, 0.995) < 5e-3
    np.testing.assert_allclose(level.numpy(), np.asarray(j_level),
                               atol=0.05)
    assert set(new_state) == {"chan", "dc", "groups"}


def test_entry_defaults_to_the_kernel_path():
    """Without ``block_len`` the pipeline picks its own, aligned for the
    kernels (128 channel steps), the FM group takes the fused route, and
    the controls are tensors on the pipeline's device; a second step
    carries the first's state."""
    fn, (state, iq) = entry("cpu")
    assert iq.re.shape[0] % (8 * 128) == 0
    state, mix, level = fn(state, iq)
    state, mix2, _ = fn(state, iq)
    assert torch.isfinite(mix).all() and torch.isfinite(mix2).all()
    assert mix.shape == mix2.shape and level.shape == (16,)


def test_entry_on_the_card_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_dryrun_multichip_is_reexported():
    from cubicsdr_tpu_torch.parallel.dryrun import dryrun_multichip
    assert entry_mod.dryrun_multichip is dryrun_multichip
    assert set(entry_mod.__all__) == {"entry", "dryrun_multichip"}
