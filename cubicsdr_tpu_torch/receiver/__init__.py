"""Receiver: channel frontend, squelch, audio mixing and the fixed-plan
pipeline (``cubicsdr_tpu/receiver``)."""

from cubicsdr_tpu_torch.receiver.frontend import ChannelFrontend  # noqa: F401
from cubicsdr_tpu_torch.receiver.mixer import mix_audio  # noqa: F401
from cubicsdr_tpu_torch.receiver.pipeline import (  # noqa: F401
    DemodGroupSpec, ReceiverPipeline)
from cubicsdr_tpu_torch.receiver.squelch import SquelchGate  # noqa: F401
