"""Receiver: channel frontend, squelch, audio mixing, the fixed-plan
pipeline, demodulator instances and their manager
(``cubicsdr_tpu/receiver``)."""

from cubicsdr_tpu_torch.receiver.frontend import ChannelFrontend  # noqa: F401
from cubicsdr_tpu_torch.receiver.mixer import mix_audio  # noqa: F401
from cubicsdr_tpu_torch.receiver.instance import (  # noqa: F401
    DemodulatorInstance)
from cubicsdr_tpu_torch.receiver.manager import DemodulatorMgr  # noqa: F401
from cubicsdr_tpu_torch.receiver.pipeline import (  # noqa: F401
    DemodGroupSpec, ReceiverPipeline, controls_from_manager,
    plan_from_manager)
from cubicsdr_tpu_torch.receiver.squelch import SquelchGate  # noqa: F401
