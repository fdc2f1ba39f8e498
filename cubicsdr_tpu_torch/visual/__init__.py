"""Visual DSP: spectrum/waterfall/scope processing
(``cubicsdr_tpu/visual``; SURVEY.md §2.6-2.7). The processors emit
display-ready arrays (normalized spectrum points, waterfall rows, scope
traces) with the reference's display math (double-EMA smoothing, auto
floor/ceil, peak hold, log scaling, palettes)."""

from cubicsdr_tpu_torch.visual.spectrum import SpectrumProcessor  # noqa: F401
from cubicsdr_tpu_torch.visual.planar_spectrum import (  # noqa: F401
    PlanarSpectrumProcessor)
from cubicsdr_tpu_torch.visual.distributor import (  # noqa: F401
    FFTDataDistributor)
from cubicsdr_tpu_torch.visual.scope import ScopeProcessor  # noqa: F401
from cubicsdr_tpu_torch.visual.waterfall import Waterfall  # noqa: F401
from cubicsdr_tpu_torch.visual.gradient import Gradient, THEMES  # noqa: F401
