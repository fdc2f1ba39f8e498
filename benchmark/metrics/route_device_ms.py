"""Mean device ms per block of the route layer (every group's route, NCO
and resampler stages): the span ``device.route`` of the receive step's
graph replay (``_device_layer.py``)."""

from benchmark.metrics._device_layer import layer_ms


def read(rec):
    return layer_ms(rec, "device.route")
