"""Crash-safe directory publication for durable artifacts.

The database snapshot writer (``storage/snapshot.py``, ``gen_<n>`` dirs)
publishes a fully-written directory with one atomic ``os.rename``; the same
writer and retention serve training checkpoints once they are ported
(``step_<n>`` dirs). This module is the home of that pattern and of two
details a plain rename misses:

  * **File durability before publish** — every file written into the tmp dir
    is fsynced before the rename, so a crash immediately after publication
    cannot leave a visible directory with zero-length files.
  * **Parent-directory fsync after rename/unlink** — the rename (and any
    retention deletes) are themselves directory-entry mutations; without
    fsyncing the parent, a crash can leave a *half-visible* entry: the old
    dir gone but the new name not yet durable, or a retention victim
    lingering as a ghost. ``fsync_dir`` closes that window.

Retention for ``<prefix><n>`` stamped directories (zero-padded monotone
integers) also lives here so every writer ages out old artifacts identically.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable

#: Zero-pad width for stamped directory names (``step_0000000042``).
STAMP_WIDTH = 10


def fsync_dir(path: str) -> None:
    """Flush directory-entry mutations (rename/unlink) under ``path`` to
    stable storage. Best-effort on platforms whose directories cannot be
    opened for fsync (e.g. Windows) — durability there is OS-defined."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _fsync_tree(root: str) -> None:
    """fsync every regular file under ``root``, then the dirs themselves."""
    for dirpath, _dirnames, filenames in os.walk(root, topdown=False):
        for name in filenames:
            fd = os.open(os.path.join(dirpath, name), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        fsync_dir(dirpath)


def publish_dir(final: str, write: Callable[[str], None],
                tmp_prefix: str = ".tmp_publish_") -> str:
    """Atomically publish a directory at ``final``.

    ``write(tmp_path)`` populates a temp dir created next to ``final`` (same
    filesystem, so the rename is atomic). On any exception the temp dir is
    removed and nothing becomes visible; on success the tree is fsynced,
    renamed into place, and the parent directory entry is made durable.
    An existing ``final`` is replaced."""
    parent = os.path.dirname(final) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=tmp_prefix)
    try:
        write(tmp)
        _fsync_tree(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        fsync_dir(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def stamped_name(prefix: str, n: int) -> str:
    return f"{prefix}{n:0{STAMP_WIDTH}d}"


def list_stamped(parent: str, prefix: str) -> list[int]:
    """Sorted stamps of every ``<prefix><n>`` directory under ``parent``
    (missing parent → empty; non-integer suffixes are ignored)."""
    try:
        names = os.listdir(parent)
    except FileNotFoundError:
        return []
    out = []
    for name in names:
        if name.startswith(prefix):
            try:
                out.append(int(name[len(prefix):]))
            except ValueError:
                pass
    return sorted(out)


def retain_stamped(parent: str, prefix: str, keep: int) -> list[int]:
    """Delete all but the newest ``keep`` stamped directories, then fsync the
    parent so the unlinks are durable (a crash mid-retention cannot leave a
    half-visible victim). Returns the stamps that were removed."""
    stamps = list_stamped(parent, prefix)
    victims = stamps[:-keep] if keep > 0 else stamps
    for n in victims:
        shutil.rmtree(os.path.join(parent, stamped_name(prefix, n)),
                      ignore_errors=True)
    if victims:
        fsync_dir(parent)
    return victims
