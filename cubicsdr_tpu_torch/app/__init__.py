"""Application core: the live receive loop and checkpoints
(``cubicsdr_tpu/app``). The app shell (config, sessions, bookmarks, rig)
is numpy-only in the JAX package and is reused from there by import."""
