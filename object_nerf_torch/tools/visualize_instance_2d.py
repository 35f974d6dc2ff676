"""Instance-map inspector CLI (the reference tools/visualize_instance_2d.py).

    python -m object_nerf_torch.tools.visualize_instance_2d path/to/123.instance-filt.png [out.png]

Counterpart of the JAX package's `tools/visualize_instance_2d.py:16-22`:
prints the instance ids present with their pixel counts and writes a
labelled colour overlay (`visualize.visualize_instance_2d`; beside the input
unless `out.png` is given). Needs numpy only.
"""

from __future__ import annotations

import sys


def main(argv) -> None:
    from .visualize import visualize_instance_2d

    if not argv:
        raise SystemExit("usage: python -m object_nerf_torch.tools.visualize_instance_2d "
                         "<instance.png> [out.png]")
    out, _ = visualize_instance_2d(argv[0], argv[1] if len(argv) > 1 else None)
    print(f"wrote {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
