"""Every modem family through the port's complex64 ReceiverPipeline, and
every modem's kit built with ``dtype=torch.complex64``, against the JAX
package's complex64 pipeline and kits (its default representation) on
the same numpy-seeded inputs, the JAX side run eagerly. Pipeline gates
as tests/torch_complex_common.py states; kit tolerances are
tests/test_torch_modems.py's (audio atol 1e-4 * max(|y|, 1), symbols
equal where the slicer's margin is >= 1e-5)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cubicsdr_tpu.modems as j_modems  # noqa: E402

from cubicsdr_tpu_torch.modems import make_modem, modem_names  # noqa: E402
from cubicsdr_tpu_torch.utils.interop import (  # noqa: E402
    constants_from_jax, state_to_numpy)
from cubicsdr_tpu_torch.utils.tree import tree_leaves  # noqa: E402
from torch_complex_common import (  # noqa: E402
    C64, FAMILY_PLANS, MARGIN, SR, capture, controls_for, pair, run_both)


@pytest.mark.parametrize("plan", sorted(FAMILY_PLANS))
def test_family_plan_matches_jax(plan):
    groups, stations = FAMILY_PLANS[plan]
    specs = [(m, bw, len(f), *(s and [s[0]])) for m, bw, f, *s in groups]
    rx, rxj = pair(specs, num_channels=8)
    assert constants_from_jax(rxj, rx)
    blocks = capture(stations, 3, rx.block_len, noise=0.01)
    outs, st, sj = run_both(rx, rxj, blocks,
                            controls_for(rx, [g[2] for g in groups]))
    assert ([(a.shape, a.dtype) for a in tree_leaves(state_to_numpy(st))]
            == [(a.shape, a.dtype) for a in jax.tree.leaves(sj[-1])])
    assert any(a.dtype == np.complex64 for a in jax.tree.leaves(sj[-1]))


def bandlimited_iq(rng, n_rows, n):
    x = (rng.standard_normal((n_rows, n + 32))
         + 1j * rng.standard_normal((n_rows, n + 32)))
    k = np.hanning(33)
    y = np.stack([np.convolve(r, k)[32:n + 32] for r in x])
    return (y / np.abs(y).max()).astype(np.complex64)


@pytest.mark.parametrize("name", modem_names())
def test_kit_complex_matches_jax(rng, name):
    """Each registered modem's kit built with dtype=torch.complex64
    against the JAX kit built with its default complex64, batch 2, three
    streamed blocks (tests/test_torch_modems.py's tolerances)."""
    modem, modem_j = make_modem(name), j_modems.make_modem(name)
    rate = modem.check_sample_rate(modem.default_sample_rate, SR)
    L = int(np.lcm(modem.block_multiple(rate, SR), 16)) * 4
    kit = modem.build_kit(rate, SR, batch_shape=(2,), dtype=C64)
    kit_j = modem_j.build_kit(rate, SR, batch_shape=(2,))
    x = bandlimited_iq(rng, 2, 3 * L)
    st, stj = kit.init_state(), kit_j.init_state()
    assert ([(a.shape, a.dtype) for a in tree_leaves(state_to_numpy(st))]
            == [(np.shape(a), np.asarray(a).dtype)
                for a in jax.tree.leaves(stj)])
    for b in range(3):
        blk = x[..., b * L:(b + 1) * L]
        margin = (kit.decision_margin(st, torch.from_numpy(blk))
                  if modem.modem_type == "digital" else None)
        st, y = kit.apply(st, torch.from_numpy(blk))
        stj, yj = kit_j.apply(stj, jnp.asarray(blk))
        if isinstance(y, dict):
            got, ref = y["symbols"].numpy(), np.asarray(yj["symbols"])
            assert not ((got != ref) & (margin.numpy() >= MARGIN)).any()
        else:
            ref = np.asarray(yj)
            scale = max(float(np.abs(ref).max()), 1.0)
            np.testing.assert_allclose(y.numpy(), ref, atol=1e-4 * scale,
                                       rtol=0, err_msg=name)
