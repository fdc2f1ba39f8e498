"""The benchmark's plain reference: a frozen copy of the receive chain's
plain PyTorch path and of the display chain (channelizer, route, NCO and
resamplers, every modem kit, squelch, mix, waterfall re-block and
spectrum EMA), float32, with no CUDA kernel, no graph and no live loop.
It imports nothing of the program: ``step.py`` builds the deployment
from its configuration file and works out every filter design, table and
state again."""
