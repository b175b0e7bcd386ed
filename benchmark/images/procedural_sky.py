"""The demo's equirect sky: a blue-to-horizon gradient with a bright sun
disc (sky about 10², sun about 10⁴ before the material's ×0.01).

Frozen copy of ``procedural_sky_image`` in ``ptx_torch/scenes/builders.py``
at commit 4da45c6.
"""

import numpy as np


def make(height: int = 64, width: int = 128) -> np.ndarray:
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    v = ys / (height - 1)
    u = xs / (width - 1)
    sky = 100.0 * np.stack([0.25 + 0.3 * v, 0.4 + 0.4 * v, 0.7 + 0.3 * v], axis=-1)
    sun = np.exp(-(((u - 0.7) * 18) ** 2 + ((v - 0.75) * 18) ** 2))
    img = sky + sun[..., None] * np.array([4000.0, 3600.0, 3000.0], np.float32)
    return np.concatenate([img, np.ones((height, width, 1), np.float32)], axis=-1)
