"""`imageio.v2.imread` on OpenCV, for a machine without imageio.

The port's loaders decode frames with `imageio.v2.imread` (imported when
a frame is read). The card's machine has OpenCV and no imageio, so the
run registers this module under that name before it builds the engine,
and the loaders run unchanged. It returns what imageio returns for the
sequences the benchmark writes: RGB uint8 (H, W, 3) for colour and the
stored uint16 (H, W) for 16-bit depth PNGs.
"""
from __future__ import annotations

import sys
import types


def imread(path):
    import cv2
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise OSError(f"cannot read {path}")
    if img.ndim == 3:
        code = cv2.COLOR_BGRA2RGBA if img.shape[2] == 4 else cv2.COLOR_BGR2RGB
        img = cv2.cvtColor(img, code)
    return img


def install() -> None:
    """Make `import imageio.v2` give this reader, in this process."""
    v2 = types.ModuleType("imageio.v2")
    v2.imread = imread
    pkg = types.ModuleType("imageio")
    pkg.v2 = v2
    pkg.__path__ = []
    sys.modules["imageio"] = pkg
    sys.modules["imageio.v2"] = v2
