"""The template dataset: random scalar pairs (x, x^2).

Port of ``nerfsr_tpu/data/template.py``: 1000 pairs in ``train`` mode and
64 in any other, x uniform in [-2, 2) from ``RandomState(--seed)``, for
the template system (``nerfsr_torch/models/template_system.py``).
"""

from __future__ import annotations

import numpy as np

from nerfsr_torch.data import register_dataset


@register_dataset("template")
class TemplateDataset:
    def __init__(self, opt, mode):
        self.opt = opt
        self.mode = mode
        self.n = 1000 if mode == "train" else 64
        rng = np.random.RandomState(opt.seed)
        self.x = (rng.rand(self.n, 1).astype(np.float32) - 0.5) * 4
        self.y = self.x ** 2

    def __len__(self):
        return self.n

    def ray_buffer(self):
        return {"x": self.x, "y": self.y}

    def image_rays(self, idx):
        return {"x": self.x[idx:idx + 1], "y": self.y[idx:idx + 1]}
