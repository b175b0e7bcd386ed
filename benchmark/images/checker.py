"""Config 4's surface texture: a checker of ``squares`` × ``squares``
squares over ``size`` × ``size`` texels, in the colours of the port's
``builders._checker_image`` at commit 79562cc (dark 0.2, 0.25, 0.3; light
0.8, 0.75, 0.7; alpha 1), the dark square at the top left.

A configuration that names this image has a texture on a surface slot, so
loading the formula also puts the reference's reading of such slots in
place (:func:`benchmark.reference.textures.install`): a run writes every
image of its configuration before it reads the scene.
"""

import numpy as np

from benchmark.reference import textures

textures.install()


def make(size: int = 1024, squares: int = 8) -> np.ndarray:
    cell = size // squares
    yy, xx = np.mgrid[0:size, 0:size]
    c = ((yy // cell + xx // cell) % 2).astype(np.float32)
    return np.stack([0.2 + 0.6 * c, 0.25 + 0.5 * c, 0.3 + 0.4 * c, np.ones_like(c)],
                    axis=-1)
