"""Bit-continuous checkpoint/resume of pipeline state
(``cubicsdr_tpu/app/checkpoint.py``).

The whole carried state (filter histories, NCO phases, EMA trackers) is
saved to one ``.npz`` and restored, so a resumed stream continues
bit-continuously. The file layout is the JAX package's: leaves
``leaf_0 .. leaf_{n-1}`` in ``jax.tree_util.tree_flatten`` order (dict keys
sorted, tuples in order, a planar pair as (re, im)) plus a JSON
``__meta__``. A checkpoint written by either package loads into the
other.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from cubicsdr_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_state(path: str, state, meta: dict | None = None):
    """Serialize a state nest of tensors or arrays to an .npz (+ JSON
    meta)."""
    arrays = {f"leaf_{i}": _np(x) for i, x in enumerate(tree_leaves(state))}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), np.uint8)
    np.savez(path, **arrays)
    return path


def load_state(path: str, like_state):
    """Restore into the structure of ``like_state`` (e.g. a fresh
    ``pipeline.init_state()``), each leaf on its counterpart's device.
    Returns (state, meta). Raises ValueError when a leaf's shape differs
    (the plan changed)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode()) \
            if "__meta__" in z else {}
        flat = []
        for i, ref in enumerate(tree_leaves(like_state)):
            arr = z[f"leaf_{i}"]
            if arr.shape != tuple(ref.shape):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {arr.shape} != pipeline "
                    f"shape {tuple(ref.shape)} — plan changed?")
            flat.append(torch.as_tensor(arr, device=ref.device))
    return tree_unflatten(like_state, flat), meta


def save_sharded_state(path: str, rx, state, meta: dict | None = None):
    """Checkpoint a ``ShardedReceiver``'s state: every rank's shard is
    gathered (a collective: every rank calls this) into the JAX package's
    global layout (leaves [nt, ...], demod rows in global order), and rank
    0 writes it, so the file loads into either package's sharded
    receiver on the same mesh shape."""
    import torch.distributed as dist
    glob = rx.gather_state(state)
    if not dist.is_initialized() or dist.get_rank() == 0:
        save_state(path, glob, meta)
    if dist.is_initialized():
        dist.barrier()
    return path


def load_sharded_state(path: str, rx):
    """This rank's shard of a checkpoint written by ``save_sharded_state``
    (or by the JAX package's ``rx --mesh``). Returns (state, meta);
    raises ValueError when the plan or the mesh shape changed."""
    like = rx.init_state()
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode()) \
            if "__meta__" in z else {}
        leaves = [z[f"leaf_{i}"] for i in range(len(tree_leaves(like)))]
    return rx.place_state(tree_unflatten(like, leaves)), meta
