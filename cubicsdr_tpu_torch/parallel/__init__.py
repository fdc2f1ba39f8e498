"""The sharded receiver on ``torch.distributed``
(``cubicsdr_tpu/parallel``).

The JAX package runs one SPMD program over a ('time', 'chan') device mesh.
The port runs one process per rank and one device per process: a
``DeviceMesh`` with the same two axes, and collectives on its sub-groups.

  'time': the IQ block is split into contiguous spans, one per time rank.
          Every FIR-like stage consumes (history, samples); the history is
          the previous rank's tail, received by one cyclic permute per
          stage per block (``halo.py`` and the StreamOp protocol). The
          cyclic wrap hands rank 0 the last rank's tail, the end of the
          previous block, so streaming stays bit-continuous.
  'chan': demodulator rows are split across ranks; the mix is a sum over
          'chan'.
"""

from cubicsdr_tpu_torch.parallel.mesh import (  # noqa: F401
    Axis, ReceiverMesh, make_receiver_mesh)
from cubicsdr_tpu_torch.parallel.halo import halo_exchange  # noqa: F401
from cubicsdr_tpu_torch.parallel.sharded import ShardedReceiver  # noqa: F401
