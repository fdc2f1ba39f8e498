"""cubicsdr_tpu_torch — the PyTorch/CUDA port of ``cubicsdr_tpu``.

Module paths and class names mirror the JAX package, so each counterpart is
found under the same name (``cubicsdr_tpu.ops.channelizer.ChannelizerPFB2``
-> ``cubicsdr_tpu_torch.ops.channelizer.ChannelizerPFB2``). Stages are
``torch.nn.Module``s that keep the JAX package's explicit streaming
contract ``apply(state, x) -> (state, y)``; their constant taps, DFT and
Toeplitz matrices are registered buffers, so ``.to(device)`` moves them.

Ported so far: the receive step (``receiver.pipeline.ReceiverPipeline``
with ``dtype=PLANAR`` or ``dtype=torch.complex64`` in every channelizer
mode, 'pfbch2', 'pfbch' and 'single') with the whole modem bank, analog
and digital, the live loop (``app.runner``), the app shell: the web
control plane (``app.webview``), the CLI (``python -m
cubicsdr_tpu_torch``), config, sessions, bookmarks, rig control and the
IQ sources, and the sharded receiver with its scaling harness and dry
run (``parallel``). Its two hot stages run hand-written CUDA kernels for
Hopper (``csrc/pfb.cu``, ``csrc/route.cu``) on planar data when
``use_kernels`` is on (the planar default) and the data lies on a CUDA
device; on CPU tensors the same wrappers run their plain PyTorch
versions. The complex64 path runs no kernel, as the JAX package's.

This package never imports jax.
"""

import torch

# TF32 keeps ~10 mantissa bits: the JAX package measured that a TF32-class
# matmul degrades this signal path well below its 60 dB stop-band
# (cubicsdr_tpu/ops/resample.py:_signal_precision), so every float32
# product here runs in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# On the CPU, torch's transcendental functions (cos, sin, exp, log, ...)
# call MKL's vector math library, which sets itself up at its first call
# in the process. When that first call is split over several threads (a
# tensor above the op's grain size), some threads can run their chunk in
# MKL's low-accuracy mode: cos off by up to 1.5e-4 instead of 4e-8, in
# 40 of 280 fresh processes on an Intel Xeon with AVX-512. One call on one
# thread (a one-element tensor) sets the library up first (tests/
# test_torch_route.py, test_first_parallel_cos_of_a_process_is_accurate).
torch.cos(torch.zeros(1))

__version__ = "0.1.0"
