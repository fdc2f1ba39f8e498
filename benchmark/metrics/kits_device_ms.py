"""Mean device ms per block of the modem-kit layer (every group's modem kit
and squelch gate, and the audio mix): the span ``device.kits`` of the
receive step's graph replay (``_device_layer.py``)."""

from benchmark.metrics._device_layer import layer_ms


def read(rec):
    return layer_ms(rec, "device.kits")
