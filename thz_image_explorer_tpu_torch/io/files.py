"""Filesystem helpers: the port's own copy of
``thz_image_explorer_tpu/io/files.py``."""

from __future__ import annotations

import os


def find_files_with_same_extension(file_path: str) -> list[str]:
    """Sorted files in the same directory sharing the extension, for
    prev/next navigation (``io.rs:285-308``)."""
    directory = os.path.dirname(os.path.abspath(file_path))
    _, ext = os.path.splitext(file_path)
    if not directory or not ext:
        return []
    out = []
    try:
        for name in os.listdir(directory):
            p = os.path.join(directory, name)
            if os.path.isfile(p) and os.path.splitext(name)[1] == ext:
                out.append(p)
    except OSError:
        return []
    return sorted(out)
