"""The step's device marks (``cubicsdr_tpu_torch/utils/compiled.py``
``device_mark``, ``CompiledStep.mark_ms``): each mark's interval, a
repeated name refused, and on the card (marked ``card``; run with
``python -m pytest tests/test_torch_device_marks.py -m card`` on a
machine with a GPU) the marks timed only in a step built with them.
Imports nothing of the JAX package, so it runs where JAX is absent."""

from __future__ import annotations

import pytest
import torch

from cubicsdr_tpu_torch.utils.compiled import CompiledStep, device_mark


class _Event:
    """A stand-in for a timing event recorded at ``t`` ms."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_mark_ms_splits_the_graph_and_refuses_a_repeated_name():
    """Each mark reads the ms from the mark before it (or the graph's
    start); a graph that marks one name twice (several steps in one
    graph) raises instead of reporting one of them."""
    step = CompiledStep(lambda s, x: (s, x), "cpu", marks=True)
    step._timing = [(_Event(1.0), _Event(9.0),
                     (("chan", _Event(1.5)), ("route", _Event(4.0)),
                      ("kits", _Event(8.5))))]
    assert step.mark_ms(0) == {"chan": 0.5, "route": 2.5, "kits": 4.5}
    step._timing = [(_Event(0.0), _Event(9.0),
                     (("chan", _Event(1.0)), ("route", _Event(2.0)),
                      ("chan", _Event(3.0))))]
    with pytest.raises(ValueError, match="'chan' more than once"):
        step.mark_ms(0)


@pytest.mark.card
def test_card_marks_time_only_a_step_built_with_them():
    """On the card: a step built with ``marks=True`` reads one interval
    per mark, each within the graph's own time; one built without them
    records none, so a graph of several marked steps stays unmarked;
    built with them, such a graph refuses to read its marks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    def one(state, x):
        y = torch.fft.fft(x + state)
        device_mark("chan")
        z = (y * y.conj()).real
        device_mark("kits")
        return state + 1, z

    def two(state, x):
        state, _ = one(state, x)
        return one(state, x)
    x = torch.randn(64, 4096, device="cuda")
    s0 = torch.zeros_like(x)
    marked = CompiledStep(one, "cuda", marks=True)
    for _ in range(3):
        marked(s0, x)
    torch.cuda.synchronize()
    k = marked.last
    ms = marked.mark_ms(k)
    assert list(ms) == ["chan", "kits"] and min(ms.values()) >= 0
    assert sum(ms.values()) <= marked.device_ms(k) + 1e-3
    plain = CompiledStep(two, "cuda")
    plain(s0, x)
    torch.cuda.synchronize()
    assert plain.mark_ms(plain.last) == {}
    both = CompiledStep(two, "cuda", marks=True)
    both(s0, x)
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="more than once"):
        both.mark_ms(both.last)
