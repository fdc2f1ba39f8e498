"""Carry state and constants between the JAX package and the port.

The JAX package is the reference; its pipeline state, converted leaf by
leaf to numpy (e.g. ``jax.tree.map(np.asarray, state)``), continues the
stream in the port, and back. The port's "weights" are its constant taps
and matrices: ``constants_from_jax`` checks each one the port built
against the JAX pipeline's. Nothing here imports jax: a JAX state or
pipeline is only read through its attributes and numpy conversion.
"""

from __future__ import annotations

import numpy as np
import torch

from cubicsdr_tpu_torch.ops.planar import PC
from cubicsdr_tpu_torch.ops.resample import _toeplitz_np
from cubicsdr_tpu_torch.receiver.frontend import RoutedChannelFrontend
from cubicsdr_tpu_torch.utils.tree import tree_map


def _is_pc(node) -> bool:
    return getattr(node, "_fields", None) == ("re", "im")


def state_from_numpy(tree, device=None):
    """A JAX state with numpy (or jax array) leaves -> the port's state:
    tensors on ``device``, planar (re, im) NamedTuples as the port's
    ``PC``, dtypes kept. Serves the pipeline state and the visual states
    alike: the distributor's ``(hist PC, next_pos)`` and the spectrum
    dict, ``primed`` staying bool."""
    def node(nt, kids):
        return PC(*kids) if _is_pc(nt) else type(nt)(*kids)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    tree, node_map=node)


def state_to_numpy(state):
    """The port's state -> the same nest with numpy leaves (``PC`` kept)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), state)


def live_state_from_jax(lr_jax, lr) -> None:
    """Continue a JAX ``LiveReceiver``'s stream in the port's ``lr`` (same
    plan and display configuration): its pipeline state and the waterfall
    chain's distributor and spectrum states move over. Rings, views and
    sinks are not state and stay the port's own."""
    dev = lr.device
    with lr.step_lock:
        lr.state = state_from_numpy(lr_jax.snapshot_state(), dev)
        lr._st_dist = state_from_numpy(lr_jax._st_dist, dev)
        lr._st_spec = state_from_numpy(lr_jax._st_spec, dev)


def _pairs(rx_jax, rx):
    """(name, JAX value, port value) for every plan scalar, tap and
    matrix."""
    for attr in ("M", "chan_rate", "block_len", "audio_len"):
        yield attr, getattr(rx_jax, attr), getattr(rx, attr)
    ch_j, ch = rx_jax.channelizer, rx.channelizer
    if (ch_j is None) != (ch is None):
        raise ValueError("one pipeline has a channelizer, the other not")
    if ch is not None:                       # 'single' mode has none
        yield "channelizer.h_poly", ch_j.h_poly, ch.h_poly
        yield "channelizer.c.re", np.asarray(ch_j.c_pc.re)[:, 0], ch.c_re
        yield "channelizer.c.im", np.asarray(ch_j.c_pc.im)[:, 0], ch.c_im
    for gi, (fe_j, fe) in enumerate(zip(rx_jax.frontends, rx.frontends)):
        for si, (a, b) in enumerate(zip(_stages(fe_j.resampler),
                                        _stages(fe.resampler))):
            yield f"frontends[{gi}].stage[{si}].ker", a.ker, b.ker
        if isinstance(fe, RoutedChannelFrontend):
            # The JAX kernel builds its tile matrix from its stage kernel
            # with the same banded layout.
            rs = fe_j._stage1
            T, _, _ = _toeplitz_np(
                tuple(np.asarray(rs.ker).reshape(-1).tolist()), rs.P, rs.Q,
                rs.KK, fe.tile)
            yield f"frontends[{gi}].toep", T, fe._stage1.toeplitz(fe.tile)[0]
    for gi, (k_j, k) in enumerate(zip(rx_jax.kits, rx.kits)):
        for name, buf in k.named_buffers():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _DERIVED:
                continue
            yield f"kits[{gi}].{name}", _jax_constant(k_j, name), buf


def _stages(resampler):
    return list(getattr(resampler, "stages", [resampler]))


# Kit buffers built from other constants (tile matrices, kernel tap
# layouts) or holding none: checked through their sources.
_DERIVED = ("_anchor", "route_taps")


def _jax_constant(kit_j, name: str):
    """The JAX kit's constant at the port buffer path ``name``: the same
    attribute path (``stages.0`` indexes a list), with complex FIR taps
    split into planes (``taps_re``/``taps_im``) and a first-order
    section's float64 numerator cast as the port holds it (``b_taps``)."""
    *path, leaf = name.split(".")
    obj = kit_j
    for part in path:
        obj = obj[int(part)] if part.isdigit() else getattr(obj, part)
    if leaf.startswith("toep_"):
        rs = obj
        return _toeplitz_np(tuple(np.asarray(rs.ker).reshape(-1).tolist()),
                            rs.P, rs.Q, rs.KK, int(leaf[5:]))[0]
    if leaf in ("taps_re", "taps_im"):
        t = np.asarray(obj.taps)
        return (t.real if leaf == "taps_re" else t.imag).astype(np.float32)
    if leaf == "b_taps":
        return np.asarray(obj.b).astype(np.float32)
    return getattr(obj, leaf)


def constants_from_jax(rx_jax, rx) -> list[str]:
    """Check that every tap and matrix the port pipeline ``rx`` built
    equals the JAX pipeline ``rx_jax``'s exactly; return the names
    checked, raise ValueError on the first mismatch."""
    names = []
    for name, a, b in _pairs(rx_jax, rx):
        a = np.asarray(a)
        b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
        if a.shape != b.shape or not np.array_equal(a, b):
            raise ValueError(f"constant {name} differs from the JAX "
                             f"package's")
        names.append(name)
    return names
