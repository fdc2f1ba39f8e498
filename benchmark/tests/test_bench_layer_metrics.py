"""The readers of the receive step's device layers (``chan_device_ms``,
``route_device_ms``, ``kits_device_ms``) on span logs written here: each
averages its layer's span over the traced run's blocks, and reads None
where the log holds no such span (a CPU run) or the program records none
(a program without the layers' spans)."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import registry
from benchmark.run import N_WARM
from cubicsdr_tpu_torch.app import runner as R
from cubicsdr_tpu_torch.utils.metrics import SPANS

READERS = {"chan_device_ms": "device.chan", "route_device_ms": "device.route",
           "kits_device_ms": "device.kits"}
N = 6


def _log(layers: bool):
    """A new log of N warm and N window blocks: every block's device.step
    (2 ms), and with ``layers`` each layer's span, the window's block k
    at 0.1 (k + 1) ms times the layer's place (1, 2, 3)."""
    log = SPANS.log()
    for seq in range(N_WARM + N):
        log.add(R._DEV_STEP, seq, 0, 2_000_000)
        if not layers:
            continue
        for i, span in enumerate(R._DEV_LAYER.values(), 1):
            k = max(0, seq - N_WARM)
            log.add(span, seq, 0, 100_000 * (k + 1) * i)
    return log


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_layer_reader_averages_its_span_over_the_window(name):
    log = _log(True)
    assert SPANS.latest() is log
    i = R.DEVICE_LAYERS.index(READERS[name]) + 1
    got = registry.metric_reader(name)({"host_blocks": N})
    assert got == pytest.approx(0.1 * i * np.mean(np.arange(1, N + 1)))
    # The first host_blocks window blocks only.
    got = registry.metric_reader(name)({"host_blocks": 2})
    assert got == pytest.approx(0.1 * i * 1.5)
    del log


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_layer_reader_reads_none_without_its_span(name, monkeypatch):
    log = _log(False)
    assert SPANS.latest() is log
    read = registry.metric_reader(name)
    assert read({"host_blocks": N}) is None
    assert read({}) is None
    # A program whose block_spans has no such span at all.
    orig = R.block_spans
    monkeypatch.setattr(R, "block_spans", lambda *a, **kw: {
        k: v for k, v in orig(*a, **kw).items() if k != READERS[name]})
    del log
    log = _log(True)
    assert read({"host_blocks": N}) is None
    del log
