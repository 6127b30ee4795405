"""The pix2pix history of generated images for the discriminator's updates.

Port of ``nerfsr_tpu/utils/image_pool.py`` (the reference's
``utils/image_pool.py``): until the pool holds ``pool_size`` images each
query image is stored and returned as it is; after that, with
probability 1/2 it is swapped with a buffered image drawn at random
(the discriminator sees the buffered one), else it passes through. The
draws come from ``numpy.random.RandomState(seed)`` in the JAX module's
order, so for a seed and a stream of query batches both return the same
images. Host numpy: the engine's single-step route feeds its output to
``RefineSystem.gan_train_step``; the chunks keep a device pool
(``RefineSystem._pool_query``).
"""

from __future__ import annotations

import numpy as np


class ImagePool:
    def __init__(self, pool_size: int = 50, seed: int = 0):
        self.pool_size = pool_size
        self.images = []
        self.rng = np.random.RandomState(seed)

    def query(self, images: np.ndarray) -> np.ndarray:
        """images: (N, H, W, C) freshly generated. Returns a batch of the
        same shape mixing them with buffered ones."""
        if self.pool_size <= 0:
            return images
        out = []
        for img in np.asarray(images):
            if len(self.images) < self.pool_size:
                self.images.append(img.copy())
                out.append(img)
            elif self.rng.rand() > 0.5:
                idx = self.rng.randint(len(self.images))
                out.append(self.images[idx].copy())
                self.images[idx] = img.copy()
            else:
                out.append(img)
        return np.stack(out)
