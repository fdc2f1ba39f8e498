"""The reference matches the program on the CPU at a small block of each
configuration: the same capture through ``cubicsdr_tpu_torch``'s
pipeline and display chain (the kernels' plain versions run on the
CPU) and through the reference, block for block, outputs and states."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, synth
from benchmark.reference.step import RefDeployment

ROOT = Path(__file__).resolve().parents[2]


def program_blocks(cfg, wire_blocks):
    """The program's pipeline and display chain over the blocks, as the
    live loop's step and post-step run them; host outputs per block and
    the final pipeline state."""
    from cubicsdr_tpu_torch.ops.planar import PC
    from cubicsdr_tpu_torch.receiver import DemodGroupSpec, ReceiverPipeline
    from cubicsdr_tpu_torch.visual import (
        FFTDataDistributor, PlanarSpectrumProcessor)
    specs = [DemodGroupSpec(g["modem"], g["bandwidth"], g["count"])
             for g in cfg["groups"]]
    rx = ReceiverPipeline(cfg["sample_rate"], specs,
                          num_channels=cfg["num_channels"],
                          block_len=cfg["block_len"], device="cpu")
    ctl = rx.control_template()
    for c, g in zip(ctl, cfg["groups"]):
        c["frequency"] = np.asarray(g["offsets"], np.float32)
    d = cfg["display"]
    dist = FFTDataDistributor(d["fft"] * 2, cfg["sample_rate"],
                              lines_per_second=d["lines_per_second"],
                              block_len=cfg["block_len"])
    spec = PlanarSpectrumProcessor(d["fft"])
    st, sd, ss = rx.init_state(), dist.init_state(), spec.init_state()
    outs = []
    for w in wire_blocks:
        x = PC(torch.from_numpy(w[0]).float() / 32768.0,
               torch.from_numpy(w[1]).float() / 32768.0)
        st, out = rx.apply(st, (x, ctl))
        sd, (frames, valid) = dist.apply(sd, out["iq"])
        ss, disp = spec.apply(ss, frames, valid=valid)
        o = {"mix": out["mix"].numpy(), "groups": [],
             "lines": int(valid.sum()),
             "points": disp["spectrum_points"].numpy()}
        for g in out["groups"]:
            h = {"level": g["level"].numpy(),
                 "iq": torch.stack([g["iq"].re, g["iq"].im]).numpy()}
            if "symbols" in g:
                h["symbols"] = g["symbols"].numpy()
            o["groups"].append(h)
        outs.append(o)
    return outs, st, rx.fused_route


@pytest.mark.parametrize("name,block_len", [("scan58", 64_000),
                                            ("fm16", 32_000)])
def test_reference_matches_the_program_on_the_cpu(name, block_len):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json"
                      ).read_text())
    cfg["block_len"] = block_len
    cfg["display"] = dict(cfg["display"], fft=256, demod_view=None)
    loop = synth.wire(synth.capture(cfg, 20260101, "cpu", n=3 * block_len),
                      cfg["wire"], cfg["wire_peak"])
    blocks = [synth.stream_block(loop, block_len, k) for k in range(3)]
    prog, prog_state, fused = program_blocks(cfg, blocks)
    ref = RefDeployment(cfg, "cpu")
    assert ref.rx.fused_route == fused
    st, post = ref.init_states()
    for k, w in enumerate(blocks):
        st, post, r = ref.block(st, post, w)
        gaps = compare.compare_block(prog[k], r)
        assert gaps["iq_gap"] < 1e-5, (k, gaps)
        assert gaps["mix_gap"] < 1e-4, (k, gaps)
        assert gaps["level_gap_db"] < 1e-4, (k, gaps)
        assert gaps["symbol_errors"] == 0 and gaps["line_errors"] == 0
        assert gaps["spectrum_gap"] < 1e-5, (k, gaps)
    assert compare.state_gap(compare.to_host_tree(prog_state),
                             compare.to_host_tree(st)) < 1e-5


def test_stream_block_wraps_the_loop():
    loop = np.arange(20, dtype=np.int16).reshape(2, 10)
    b = synth.stream_block(loop, 4, 2)        # samples 8..11, wrapped
    assert b[0].tolist() == [8, 9, 0, 1]
    assert b[1].tolist() == [18, 19, 10, 11]


def test_the_capture_follows_the_seed():
    cfg = json.loads((ROOT / "benchmark" / "configs" / "scan58.json"
                      ).read_text())
    a = synth.capture(cfg, 2**31 + 11, "cpu", n=4000)
    b = synth.capture(cfg, 2**31 + 11, "cpu", n=4000)
    c = synth.capture(cfg, 2**31 + 12, "cpu", n=4000)
    assert torch.equal(a, b) and not torch.equal(a, c)
    w = synth.wire(a, "cs16", 0.5)
    assert w.dtype == np.int16 and int(np.abs(w).max()) == 16384
