"""Mean device ms per block of the channelizer layer (the wire format's
conversion, the PFB and the DC blocker on channel 0): the span
``device.chan`` of the receive step's graph replay (``_device_layer.py``)."""

from benchmark.metrics._device_layer import layer_ms


def read(rec):
    return layer_ms(rec, "device.chan")
