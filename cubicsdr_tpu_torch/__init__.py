"""cubicsdr_tpu_torch — the PyTorch/CUDA port of ``cubicsdr_tpu``.

Module paths and class names mirror the JAX package, so each counterpart is
found under the same name (``cubicsdr_tpu.ops.channelizer.ChannelizerPFB2``
-> ``cubicsdr_tpu_torch.ops.channelizer.ChannelizerPFB2``). Stages are
``torch.nn.Module``s that keep the JAX package's explicit streaming
contract ``apply(state, x) -> (state, y)``; their constant taps, DFT and
Toeplitz matrices are registered buffers, so ``.to(device)`` moves them.

Ported so far: the receive step (``receiver.pipeline.ReceiverPipeline``
with ``dtype=PLANAR`` in every channelizer mode, 'pfbch2', 'pfbch' and
'single') with the whole modem bank, analog and digital, the live loop
(``app.runner``), and the app shell: the web control plane
(``app.webview``), the CLI (``python -m cubicsdr_tpu_torch``), config,
sessions, bookmarks, rig control and the IQ sources. Its two hot
stages run hand-written CUDA kernels for Hopper
(``csrc/pfb.cu``, ``csrc/route.cu``) when ``use_kernels=True`` and the data
lies on a CUDA device; on CPU tensors the same wrappers run their plain
PyTorch versions.

This package never imports jax.
"""

import torch

# TF32 keeps ~10 mantissa bits: the JAX package measured that a TF32-class
# matmul degrades this signal path well below its 60 dB stop-band
# (cubicsdr_tpu/ops/resample.py:_signal_precision), so every float32
# product here runs in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
