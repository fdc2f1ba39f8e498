"""Host-side IO: IQ sources (the device layer stand-in), WAV writing,
recording policy (the port's counterpart of ``cubicsdr_tpu/io``)."""

from cubicsdr_tpu_torch.io.wav import WavWriter, write_wav, read_wav  # noqa: F401
from cubicsdr_tpu_torch.io.sources import (  # noqa: F401
    FileIQSource, SyntheticSource, optimal_block_len, optimal_channel_count)
from cubicsdr_tpu_torch.io.recorder import RecordingSink, SquelchOption  # noqa: F401
