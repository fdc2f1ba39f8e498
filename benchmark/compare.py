"""The comparison that decides ``correct``: what the live loop handed the
host for a block against what the reference computes for it, and the
program's state after a block against the reference's.

Each number is the worst over the blocks compared:

- ``iq_gap``: per group, the largest gap of its demods' IQ taps (route,
  NCO and resample after the channelizer) over the group's rms;
- ``mix_gap``: the largest gap of the audio mix (every analog kit,
  squelch and the mix) over its rms;
- ``level_gap_db``: the largest gap of a demod's level, in dB;
- ``symbol_errors``: symbols that differ (the digital kits' slicers);
- ``spectrum_gap``: the largest gap of the main spectrum's and the demod
  view's display points (0..1 scale), NaN only where both are NaN;
- ``line_errors``: blocks whose waterfall line count differs;
- ``state_gap``: per state leaf, the largest gap over the larger of the
  leaf's rms and the median leaf's rms (whole-valued leaves, such as
  step parities, must agree exactly);
- ``lost_blocks``: blocks due in the window that never reached the host
  (the harness counts them).
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("iq_gap", "mix_gap", "level_gap_db", "symbol_errors",
           "spectrum_gap", "line_errors", "state_gap", "lost_blocks")


def _rms(a) -> float:
    a = np.asarray(a, np.float64)
    return float(np.sqrt(np.mean(a * a))) if a.size else 0.0


def _gap(a, b) -> float:
    """Largest |a - b|; a NaN on one side only is an infinite gap."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    na, nb = np.isnan(a), np.isnan(b)
    if (na != nb).any():
        return float("inf")
    d = np.abs(np.where(na, 0.0, a) - np.where(nb, 0.0, b))
    return float(d.max()) if d.size else 0.0


def _rel(a, ref) -> float:
    g = _gap(a, ref)
    return g / max(_rms(ref), 1e-12)


def compare_block(prog: dict, ref: dict) -> dict:
    """Numbers for one block's host outputs (``prog`` as the live loop
    handed them to ``on_block``, ``ref`` from ``RefDeployment.block``)."""
    out = {"iq_gap": 0.0, "mix_gap": _rel(prog["mix"], ref["mix"]),
           "level_gap_db": 0.0, "symbol_errors": 0.0,
           "spectrum_gap": 0.0, "line_errors": 0.0}
    if len(prog["groups"]) != len(ref["groups"]):
        return {k: float("inf") for k in out}
    for p, r in zip(prog["groups"], ref["groups"]):
        out["iq_gap"] = max(out["iq_gap"], _rel(p["iq"], r["iq"]))
        out["level_gap_db"] = max(out["level_gap_db"],
                                  _gap(p["level"], r["level"]))
        if ("symbols" in p) != ("symbols" in r):
            out["symbol_errors"] = float("inf")
        elif "symbols" in r:
            ps, rs = np.asarray(p["symbols"]), np.asarray(r["symbols"])
            out["symbol_errors"] += (float(np.sum(ps != rs))
                                     if ps.shape == rs.shape
                                     else float("inf"))
    if prog.get("lines") != ref["lines"]:
        out["line_errors"] = 1.0
    if ref["lines"]:
        out["spectrum_gap"] = _gap(prog.get("points"), ref["points"])
    if "demod_view" in ref:
        out["spectrum_gap"] = max(out["spectrum_gap"],
                                  _gap(prog.get("demod_view"),
                                       ref["demod_view"]))
    return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def state_gap(prog_state, ref_state) -> float:
    """The worst leaf's gap between two state nests (host arrays)."""
    pl = [np.asarray(_host(x)) for x in _leaves(prog_state)]
    rl = [np.asarray(_host(x)) for x in _leaves(ref_state)]
    if len(pl) != len(rl):
        return float("inf")
    floats = [r for r in rl if r.dtype.kind == "f" and r.size]
    med = float(np.median([_rms(r) for r in floats])) if floats else 0.0
    worst = 0.0
    for p, r in zip(pl, rl):
        if p.shape != r.shape:
            return float("inf")
        if r.dtype.kind != "f":
            if not np.array_equal(p, r):
                return float("inf")
            continue
        worst = max(worst, _gap(p, r) / max(_rms(r), med, 1e-12))
    return worst


def to_host_tree(tree):
    """A state nest with numpy leaves (copies: a CPU program's buffers
    are reused), its planar (re, im) pairs as the reference's ``PC``."""
    from benchmark.reference.ops.planar import PC
    if isinstance(tree, dict):
        return {k: to_host_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and getattr(tree, "_fields", None) == (
            "re", "im"):
        return PC(to_host_tree(tree.re), to_host_tree(tree.im))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_host_tree(v) for v in tree)
    return np.array(_host(tree))


def _host(x):
    try:
        import torch
        if torch.is_tensor(x):
            return x.detach().cpu().numpy()
    except ImportError:                      # pragma: no cover
        pass
    return x


def worst(readings: list) -> dict:
    """The worst of each number over a list of per-block readings."""
    out = {k: 0.0 for k in NUMBERS}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out[k], float(v))
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number
    is at or under its limit (a NaN never is)."""
    checks = {k: {"value": float(numbers[k]), "limit": float(limits[k])}
              for k in NUMBERS}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
