"""BookmarkMgr — grouped bookmarks, recents, frequency ranges (the port's
copy of ``cubicsdr_tpu/app/bookmarks.py``; both read and write the same
files).

Parity with src/BookmarkMgr.{h,cpp} (814 LoC): named groups of bookmark
entries, a capped recents list, saved view ranges, and the
``.backup`` / ``.lastloaded`` recovery chain on save/load
(ref: src/CubicSDR.cpp:145-198,417-428).
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass, field, asdict

BOOKMARK_RECENTS_MAX = 25


@dataclass
class BookmarkEntry:
    label: str = ""
    user_label: str = ""
    frequency: float = 0.0
    bandwidth: float = 200000.0
    demod_type: str = "FM"
    gain: float = 1.0
    squelch_enabled: bool = False
    squelch_level: float = -100.0
    settings: dict = field(default_factory=dict)

    @staticmethod
    def from_demod(d) -> "BookmarkEntry":
        return BookmarkEntry(
            label=d.label, user_label=d.user_label, frequency=d.frequency,
            bandwidth=d.bandwidth, demod_type=d.demod_type, gain=d.gain,
            squelch_enabled=d.squelch_enabled, squelch_level=d.squelch_level,
            settings=d.read_modem_settings())


@dataclass
class BookmarkRange:
    label: str = ""
    freq: float = 0.0
    start_freq: float = 0.0
    end_freq: float = 0.0


class BookmarkMgr:
    def __init__(self):
        self.groups: dict[str, list[BookmarkEntry]] = {}
        self.recents: list[BookmarkEntry] = []
        self.ranges: list[BookmarkRange] = []
        self.expand_state: dict[str, bool] = {}

    # --- groups ---
    def add_bookmark(self, group: str, entry: BookmarkEntry):
        self.groups.setdefault(group, []).append(entry)

    def remove_bookmark(self, group: str, entry: BookmarkEntry):
        if group in self.groups and entry in self.groups[group]:
            self.groups[group].remove(entry)

    def reorder(self, group: str, i: int, to: int):
        """Move entry ``i`` to position ``to`` within its group — the
        within-group drag-drop ordering of the reference's tree
        (ref: src/forms/Bookmark/BookmarkView.cpp drag onto sibling)."""
        es = self.groups[group]
        e = es.pop(int(i))
        es.insert(int(to), e)

    def move_bookmark(self, entry: BookmarkEntry, from_group: str,
                      to_group: str):
        self.remove_bookmark(from_group, entry)
        self.add_bookmark(to_group, entry)

    def get_groups(self) -> list[str]:
        return list(self.groups)

    def get_bookmarks(self, group: str) -> list[BookmarkEntry]:
        return list(self.groups.get(group, []))

    def rename_group(self, old: str, new: str):
        if old in self.groups:
            self.groups[new] = self.groups.pop(old)

    def remove_group(self, group: str):
        self.groups.pop(group, None)

    # --- recents (ref: BookmarkMgr::addRecent, capped) ---
    def add_recent(self, entry: BookmarkEntry):
        self.recents = [r for r in self.recents
                        if not (r.frequency == entry.frequency
                                and r.demod_type == entry.demod_type)]
        self.recents.append(entry)
        if len(self.recents) > BOOKMARK_RECENTS_MAX:
            self.recents = self.recents[-BOOKMARK_RECENTS_MAX:]

    # --- ranges ---
    def add_range(self, r: BookmarkRange):
        self.ranges.append(r)

    def remove_range(self, r: BookmarkRange):
        if r in self.ranges:
            self.ranges.remove(r)

    # --- persistence with recovery chain ---
    def save_to_file(self, path: str, backup: bool = True):
        if backup and os.path.exists(path):
            shutil.copyfile(path, path + ".backup")
        doc = {
            "groups": {g: [asdict(e) for e in es]
                       for g, es in self.groups.items()},
            "recents": [asdict(e) for e in self.recents],
            "ranges": [asdict(r) for r in self.ranges],
            "expand_state": self.expand_state,
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2)
        os.replace(tmp, path)

    def _load_doc(self, path: str) -> bool:
        try:
            with open(path) as f:
                doc = json.load(f)
            self.groups = {g: [BookmarkEntry(**e) for e in es]
                           for g, es in doc.get("groups", {}).items()}
            self.recents = [BookmarkEntry(**e)
                            for e in doc.get("recents", [])]
            self.ranges = [BookmarkRange(**r) for r in doc.get("ranges", [])]
            self.expand_state = doc.get("expand_state", {})
            return True
        except (OSError, json.JSONDecodeError, TypeError):
            return False

    def load_from_file(self, path: str, use_recovery: bool = True) -> bool:
        """Try path, then .lastloaded, then .backup — the reference's
        corruption-recovery chain."""
        if os.path.exists(path) and self._load_doc(path):
            if use_recovery:
                shutil.copyfile(path, path + ".lastloaded")
            return True
        if use_recovery:
            for alt in (path + ".lastloaded", path + ".backup"):
                if os.path.exists(alt) and self._load_doc(alt):
                    return True
        return False
