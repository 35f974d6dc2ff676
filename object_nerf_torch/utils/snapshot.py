"""Run provenance: copy the source tree into the log directory.

Copy of `object_nerf_tpu/utils/snapshot.py` (the reference's
`make_source_code_snapshot`, utils/util.py:65-87, called at train start,
train.py:270): every run carries the code that produced it. The scans, run
outputs and builds at the checkout's top (`logs/`, `data/`, `debug/`,
`build/`) and caches anywhere (`.git`, `__pycache__`, `_build/`, `*.npz`)
are left out.
The JAX copy leaves out every directory named `data`, its own `data`
package among them; this one keeps the packages.
"""

from __future__ import annotations

import shutil
from pathlib import Path

_EXCLUDE_TOP = ("logs", "data", "debug", "build")
_EXCLUDE = (".git", "__pycache__", ".pytest_cache", ".claude", "_build")


def make_source_code_snapshot(log_dir, repo_root=None) -> Path:
    """Copy `repo_root` (default: the checkout holding this package) to
    `<log_dir>/source_snapshot`; returns that directory."""
    root = Path(repo_root) if repo_root else Path(__file__).resolve().parents[2]
    dest = Path(log_dir) / "source_snapshot"

    def ignore(directory, names):
        top = Path(directory).resolve() == root.resolve()
        return [n for n in names if n in _EXCLUDE or n.endswith(".npz")
                or (top and n in _EXCLUDE_TOP)]

    shutil.copytree(root, dest, ignore=ignore, dirs_exist_ok=True)
    return dest
