"""Entry points of the port (the JAX package's ``__graft_entry__.py``).

entry():            one forward step of the flagship pipeline (16-channel
                    PFBCH2 + a 16-demod FM farm + the mix) on the card.
dryrun_multichip(n): the sharded receive step over an n-rank
                    ('time' x 'chan') mesh, one step on tiny shapes
                    (``parallel/dryrun.py``).

    python -m cubicsdr_tpu_torch.entry [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cubicsdr_tpu_torch.ops.planar import PC
from cubicsdr_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: F401
from cubicsdr_tpu_torch.receiver import DemodGroupSpec, ReceiverPipeline

__all__ = ["entry", "dryrun_multichip"]


def entry(device="cuda", block_len: int | None = None):
    """The flagship step, built with the pipeline's defaults (planar, both
    CUDA kernels): 2.4 MS/s, 16 channels, 16 FM demods at (i - 8) * 140 kHz
    + 10 kHz, one block of seed-0 Gaussian IQ. Returns ``(fn, (state,
    iq))``; ``fn(state, iq)`` returns ``(state, mix [2, La], level [16])``.
    The controls are tensors on ``device``. ``block_len`` defaults to the
    pipeline's own (128-step aligned for the kernels; the JAX entry,
    built without its kernels, picks an unaligned one)."""
    fs = 2_400_000
    n_demods = 16
    rx = ReceiverPipeline(fs, [DemodGroupSpec("FM", 200000, n_demods)],
                          num_channels=16, block_len=block_len,
                          device=device)
    controls = rx.control_template()
    controls[0]["frequency"] = np.asarray(
        [(i - n_demods // 2) * 140e3 + 10e3 for i in range(n_demods)],
        np.float32)
    controls = [{k: torch.as_tensor(v, device=rx.device)
                 for k, v in c.items()} for c in controls]
    rng = np.random.default_rng(0)
    iq = PC(*(torch.from_numpy(rng.standard_normal(rx.block_len)
                               .astype(np.float32)).to(rx.device)
              for _ in range(2)))

    def fn(state, iq):
        new_state, out = rx.apply(state, (iq, controls))
        return new_state, out["mix"], out["groups"][0]["level"]

    return fn, (rx.init_state(), iq)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="one step of entry()")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, (state, iq) = entry(args.device)
    _, mix, level = fn(state, iq)
    print("entry() OK:", tuple(mix.shape), tuple(level.shape))


if __name__ == "__main__":
    main()
