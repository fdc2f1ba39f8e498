"""Application shell: the live receive loop, checkpoints, persisted
config, sessions, bookmarks, rig control, the web control plane and the
CLI (``cubicsdr_tpu/app``). Config, session and bookmark files are the
JAX package's JSON schema, so either package reads the other's files."""

from cubicsdr_tpu_torch.app.config import AppConfig, DeviceConfig  # noqa: F401
from cubicsdr_tpu_torch.app.session import SessionMgr  # noqa: F401
from cubicsdr_tpu_torch.app.bookmarks import BookmarkMgr, BookmarkEntry  # noqa: F401
