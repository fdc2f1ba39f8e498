"""The deployment's plain reference, built from its configuration file
alone: the receive chain (``receiver/pipeline.py`` of this copy, its
route and channelizer in their plain forms, the same fused layout as the
program's so that a state handed over from the program fits leaf for
leaf), the main spectrum's re-block and EMA, and the demod view on the
configured demod. ``RefDeployment.block`` takes one wire-format block
and returns the new states and what the live loop hands the host: the
mix, each group's levels, symbols and IQ tap, the spectrum points with
their line count, and the demod view's points.

``precision="bfloat16"`` is the comparison's control: the same chain
with every stage's output (the converted block, the channelizer's
channels, each group's frontend, modem-kit and squelch-gate outputs)
rounded to bfloat16, its state carried in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.ops.planar import PC
from benchmark.reference.receiver.pipeline import (
    DemodGroupSpec, ReceiverPipeline)
from benchmark.reference.utils.tree import tree_map
from benchmark.reference.visual.distributor import FFTDataDistributor
from benchmark.reference.visual.planar_spectrum import (
    PlanarSpectrumProcessor)

# The reference computes in full float32 (a float32 matmul or
# convolution may otherwise run in TF32 on the card).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _bf16(x):
    if torch.is_tensor(x) and x.is_floating_point():
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def _rounded(fn):
    def run(state, inputs):
        state, out = fn(state, inputs)
        return state, tree_map(_bf16, out)
    return run


class RefDeployment:
    def __init__(self, cfg: dict, device, precision: str = "float32"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"precision is float32 or bfloat16, not "
                             f"{precision!r}")
        self.device = torch.device(device)
        self.cfg = cfg
        specs = [DemodGroupSpec(g["modem"], int(g["bandwidth"]),
                                int(g["count"]),
                                tuple(sorted(g.get("settings", {}).items())))
                 for g in cfg["groups"]]
        # use_kernels=True asks for the fused route layout; this copy runs
        # its plain route and channelizer on every device.
        self.rx = ReceiverPipeline(
            float(cfg["sample_rate"]), specs,
            chan_mode=cfg.get("chan_mode", "pfbch2"),
            num_channels=int(cfg["num_channels"]),
            audio_rate=int(cfg.get("audio_rate", 48000)),
            block_len=int(cfg["block_len"]),
            use_kernels=True, device=self.device)
        self.controls = []
        for g, c in zip(cfg["groups"], self.rx.control_template()):
            c["frequency"] = np.asarray(g["offsets"], np.float32)
            self.controls.append(
                {k: torch.as_tensor(v, device=self.device)
                 for k, v in c.items()})
        self.scale = 1.0 / float(np.iinfo(
            {"cs16": np.int16, "cs8": np.int8}[cfg["wire"]]).max + 1)
        self.control = precision == "bfloat16"
        if self.control:
            self.rx.channelizer.apply = _rounded(self.rx.channelizer.apply)
            for m in (list(self.rx.frontends) + list(self.rx.kits)
                      + list(self.rx.gates)):
                m.apply = _rounded(m.apply)
        disp = cfg["display"]
        fs, L = float(cfg["sample_rate"]), self.rx.block_len
        lps = float(disp["lines_per_second"])
        self.dist = FFTDataDistributor(
            int(disp["fft"]) * 2, fs, lines_per_second=lps,
            block_len=L).to(self.device)
        self.spec = PlanarSpectrumProcessor(int(disp["fft"])).to(self.device)
        self.dv = disp.get("demod_view")
        if self.dv is not None:
            gi, row = self.view_row(int(self.dv))
            self.dv_group, self.dv_row = gi, row
            rate = float(self.rx.frontends[gi].bandwidth)
            self.dv_dist = FFTDataDistributor(
                int(disp["demod_view_fft"]) * 2, rate,
                lines_per_second=lps).to(self.device)
            self.dv_spec = PlanarSpectrumProcessor(
                int(disp["demod_view_fft"])).to(self.device)

    def view_row(self, idx: int):
        off = 0
        for gi, g in enumerate(self.rx.groups):
            if idx < off + g.count:
                return gi, idx - off
            off += g.count
        raise ValueError(f"demod view {idx} is past the plan's demods")

    def init_states(self):
        post = (self.dist.init_state(), self.spec.init_state(),
                (self.dv_dist.init_state(), self.dv_spec.init_state())
                if self.dv is not None else ())
        return self.rx.init_state(), post

    def to_device(self, tree):
        """A state nest of numpy or tensor leaves, as tensors here."""
        return tree_map(lambda a: torch.as_tensor(a, device=self.device)
                        if isinstance(a, (np.ndarray, np.generic))
                        or torch.is_tensor(a) else a, tree)

    @torch.no_grad()
    def block(self, state, post, wire_block: np.ndarray, taps=None):
        """One block: (state, post state, outputs) with host numpy
        outputs; ``wire_block`` is the (2, L) wire-format block. ``taps``
        (per group a [2, N, Lg] array: the IQ the judged side's frontends
        produced) makes the modem kits, squelch gates, mix and demod view
        take that IQ, while each group's ``iq`` output stays the
        reference's own: the route is judged from the block, the kits
        from the route's output."""
        w = torch.as_tensor(wire_block, device=self.device)
        x = PC(w[0].to(torch.float32) * self.scale,
               w[1].to(torch.float32) * self.scale)
        if self.control:
            x = PC(_bf16(x.re), _bf16(x.im))
        if taps is not None:
            taps = [PC(*torch.as_tensor(t, device=self.device).unbind(0))
                    for t in taps]
        state, out = self.rx.apply(state, (x, self.controls), taps=taps)
        st_dist, st_spec, st_dv = post
        st_dist, (frames, valid) = self.dist.apply(st_dist, out["iq"])
        st_spec, disp = self.spec.apply(st_spec, frames, valid=valid)
        res = {"mix": out["mix"].cpu().numpy(),
               "points": disp["spectrum_points"].cpu().numpy(),
               "lines": int(valid.sum()), "groups": []}
        for g in out["groups"]:
            h = {"level": g["level"].cpu().numpy(),
                 "iq": torch.stack([g["iq"].re, g["iq"].im]).cpu().numpy()}
            if "symbols" in g:
                h["symbols"] = g["symbols"].cpu().numpy().astype(np.int32)
            res["groups"].append(h)
        if self.dv is not None:
            tap = out["groups"][self.dv_group]["kit_in"]
            tap = PC(tap.re[self.dv_row], tap.im[self.dv_row])
            d_dist, d_spec = st_dv
            d_dist, (dfr, dval) = self.dv_dist.apply(d_dist, tap)
            d_spec, ddisp = self.dv_spec.apply(d_spec, dfr, valid=dval)
            st_dv = (d_dist, d_spec)
            res["demod_view"] = ddisp["spectrum_points"].cpu().numpy()
        return state, (st_dist, st_spec, st_dv), res
