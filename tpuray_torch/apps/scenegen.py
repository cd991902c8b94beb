"""Scene authoring CLI, the ``scene`` executable equivalent
(scene_dump.c:6-77): writes the canonical demo scene as a ``render.map``
archive.  Port of :mod:`tpuray.apps.scenegen`.

    python -m tpuray_torch.apps.scenegen [--out scenes/render.map]
"""
from __future__ import annotations

import argparse
import os

from ..scene import canonical_scene_spec
from ..sceneio import dump_scene


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="scenes/render.map")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    dump_scene(args.out, canonical_scene_spec())
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
